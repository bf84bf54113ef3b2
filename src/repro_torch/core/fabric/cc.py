"""Congestion-control models for the evaluated fabrics (paper §II).

Each fabric's mechanism is reduced to a rate-based state machine applied at
fluid-simulation granularity:

* ``dcqcn``     — RoCE with ECN hard threshold + aggressive multiplicative
                  decrease and slow additive recovery (CE8850-like). The
                  bang-bang controller + queue-drain lag is what produces the
                  paper's Fig. 3 sawtooth (Obs. 1). PFC backstop -> HOL
                  blocking when ECN fails to hold the queue.
* ``ai_ecn``    — CE9855-like AI ECN: smooth (proportional) marking against a
                  dynamically-adjusted threshold -> damped, stable response.
* ``ib``        — InfiniBand: credit-based hop-by-hop flow control + slow
                  FECN/BECN end-to-end throttling. Credits are lossless and
                  keep the hot buffer FULL under sustained incast; the
                  congestion tree then stalls upstream ingress (coarse
                  VL-granular credits -> head-of-line blocking on victim
                  flows sharing any switch of the tree). ``hol_factor``
                  models how much of a congested switch's ingress capacity
                  the backpressure takes away — the paper's Fig. 5 Leonardo
                  Incast collapse is this term. Newer IB generations mark
                  earlier and isolate better (Obs. 2) -> lower hol_factor.
* ``slingshot`` — per-flow precise feedback: only flows actually contributing
                  to a bottleneck are throttled, fast recovery, per-flow
                  queue state -> no victim HOL (hol_factor = 0)
                  (paper §II-C, Obs. 4).
"""
from __future__ import annotations

import dataclasses

KIND_DCQCN = 0
KIND_IB = 1
KIND_SLINGSHOT = 2
KIND_AI_ECN = 3

ROUTE_FIXED = 0
ROUTE_ADAPTIVE = 1

# Bounded ranges for the mitigation lab's searchable knobs
# (mitigation/search.py validates every candidate against these; each key
# is a traced SimParams field). "kind" spans the four fabric CC models —
# swapping it is the firmware-upgrade axis (e.g. CE8850 DCQCN -> AI-ECN).
SEARCH_BOUNDS = {
    "kind": (0, 3),
    "md": (0.3, 0.95),
    "rai_frac": (0.002, 0.2),
    "cc_interval_s": (10e-6, 400e-6),
    "kmin": (0.05, 0.6),
    "kmax": (0.3, 0.95),
    "hol_factor": (0.0, 1.0),
    "hol_start": (0.3, 0.95),
    "min_rate_frac": (0.005, 0.1),
    "follow_tau_s": (0.0, 200e-6),
    "follow_gain": (0.9, 1.5),
    "thresh_adapt": (0.0, 1.0),
    "flowlet_gap_s": (20e-6, 2e-3),
}


@dataclasses.dataclass(frozen=True)
class CCParams:
    kind: int
    qmax_bytes: float = 4e6  # switch egress buffer per link
    kmin: float = 0.2  # marking threshold (fraction of qmax)
    kmax: float = 0.8  # upper marking point (ai_ecn proportional band)
    md: float = 0.5  # multiplicative decrease factor on mark
    rai_frac: float = 0.02  # additive increase, fraction of link cap per ms
    cc_interval_s: float = 50e-6  # min time between decreases per flow
    # --- lossless backpressure / head-of-line blocking ---
    hol_factor: float = 0.0  # ingress capacity lost when a switch saturates
    hol_start: float = 0.55  # egress-queue fraction where HOL stall begins
    min_rate_frac: float = 0.01
    follow_tau_s: float = 0.0  # credit-window time constant; 0 = no follow.
    # Credits track the achieved rate SYMMETRICALLY (pause when buffers
    # fill, resume the instant they drain) — unlike the slow FECN/BECN
    # marking loop, which only recovers at the additive-increase rate.
    follow_gain: float = 1.1  # credit overshoot: c target = gain * achieved
    thresh_adapt: bool = False  # AI-ECN dynamic threshold
    # Ethernet NIC arrival burstiness: queues build even at line rate
    # (0 for credit-based fabrics — credits prevent overshoot).
    burst_jitter: float = 0.0
    iter_drain: float = 1.0  # queue fraction kept across victim iterations


def dcqcn() -> CCParams:
    return CCParams(kind=KIND_DCQCN, md=0.5, rai_frac=0.008,
                    cc_interval_s=100e-6, kmin=0.15, qmax_bytes=6e6,
                    hol_factor=0.85, hol_start=0.7,
                    burst_jitter=0.12, iter_drain=0.3)


def ai_ecn() -> CCParams:
    return CCParams(kind=KIND_AI_ECN, md=0.85, rai_frac=0.05,
                    cc_interval_s=50e-6, kmin=0.1, kmax=0.7,
                    thresh_adapt=True, qmax_bytes=6e6,
                    hol_factor=0.6, hol_start=0.8,
                    burst_jitter=0.08, iter_drain=0.3)


def infiniband(gen: str = "hdr") -> CCParams:
    # newer generations: better-tuned marking (earlier, before the buffer is
    # deep in the HOL regime), faster recovery, and finer credit granularity
    # (less victim HOL) — paper Obs. 2: generation matters.
    #          md    rai    hol    kmin
    tune = {"edr": (0.75, 0.020, 0.95, 0.55),
            "hdr": (0.80, 0.030, 0.90, 0.50),
            "ndr": (0.80, 0.050, 0.45, 0.20)}
    md, rai, hol, kmin = tune[gen]
    return CCParams(kind=KIND_IB, md=md, rai_frac=rai, cc_interval_s=100e-6,
                    kmin=kmin, qmax_bytes=2e6,
                    hol_factor=hol, hol_start=0.55,
                    follow_tau_s=50e-6, follow_gain=1.3)


def slingshot() -> CCParams:
    return CCParams(kind=KIND_SLINGSHOT, md=0.9, rai_frac=0.1,
                    cc_interval_s=20e-6, kmin=0.3, qmax_bytes=2e6,
                    hol_factor=0.0, follow_tau_s=15e-6, follow_gain=1.05)
