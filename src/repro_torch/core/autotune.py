"""Congestion-aware collective schedule selection (beyond-paper layer).

The paper characterizes how fabrics respond to congestion; this module
*acts* on that characterization: given a collective (kind, participant
count, payload) and a fabric model + background-traffic profile, predict
each candidate schedule's finish time and pick the winner.

Two prediction tiers:

* ``predict_analytic`` — alpha-beta model from the schedule's serialized
  step count and per-rank wire bytes (collectives.wire_bytes_model), with a
  fabric-dependent effective bandwidth. Free; used per-call.
* ``predict_simulated`` — a thin lru-cached client of the mitigation
  lab's simulator-backed scoring path (mitigation.search.simulated_times);
  captures interaction effects (HOL stall, CC transients) the alpha-beta
  model cannot. Cached; used to build offline schedule tables.

The same machinery tunes the *pod-axis* options of the training step:
gradient compression on/off trades wire bytes against quantization compute,
decided from the roofline terms of the dry-run artifact
(``choose_pod_strategy``).
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from repro_torch.core import congestion as cong
from repro_torch.core.collectives import wire_bytes_model
from repro_torch.core.fabric.systems import SystemPreset

CANDIDATES: Dict[str, Tuple[str, ...]] = {
    "all_gather": ("ring_all_gather", "bidir_ring_all_gather"),
    "all_reduce": ("ring_all_reduce",),
    "all_to_all": ("linear_all_to_all", "pairwise_all_to_all"),
}

# benchmarkable collective name for the simulator tier
_SIM_NAME = {
    "ring_all_gather": "ring_allgather",
    "bidir_ring_all_gather": "ring_allgather",
    "ring_all_reduce": "ring_allreduce",
    "linear_all_to_all": "alltoall",
    "pairwise_all_to_all": "alltoall",
}


@dataclasses.dataclass(frozen=True)
class Prediction:
    algo: str
    time_s: float
    wire_bytes: float
    steps: int
    tier: str  # "analytic" | "simulated"


def predict_analytic(kind: str, algo: str, n: int, vector_bytes: float,
                     *, link_bw: float = 50e9, step_latency_s: float = 2e-6,
                     congestion_factor: float = 1.0) -> Prediction:
    """alpha-beta: t = steps * alpha + bytes / (bw / congestion_factor)."""
    m = wire_bytes_model(algo, n, vector_bytes)
    t = m["steps"] * step_latency_s \
        + m["bytes"] * congestion_factor / link_bw
    return Prediction(algo, t, m["bytes"], m["steps"], "analytic")


@lru_cache(maxsize=256)
def _simulated_point(system_name: str, n: int, coll: str, vector_bytes: float,
                     profile_kind: str, burst_s: float, pause_s: float,
                     aggressor: str, device: Optional[str]) -> float:
    # a thin client of search.simulated_times, whose own table keys on
    # the candidate too; this cache only saves rebuilding the Profile
    from repro_torch.core.mitigation import search

    prof = {"off": cong.no_congestion(), "steady": cong.steady(),
            "bursty": cong.bursty(burst_s, pause_s)}[profile_kind]
    t_u, t_c = search.simulated_times(
        system_name, n * 2 if aggressor else n, coll, aggressor,
        vector_bytes, prof, n_iters=20, warmup=4, device=device)
    return t_c if aggressor else t_u


def predict_simulated(kind: str, algo: str, n: int, vector_bytes: float,
                      system: SystemPreset,
                      profile: Optional[cong.Profile] = None,
                      aggressor: str = "", device=None) -> Prediction:
    """The simulator tier, on ``device`` (default: the CUDA device)."""
    profile = profile or cong.no_congestion()
    t = _simulated_point(system.name, n, _SIM_NAME[algo], float(vector_bytes),
                         profile.kind, profile.burst_s, profile.pause_s,
                         aggressor, None if device is None else str(device))
    # schedule-level correction: the fluid sim models the traffic pattern;
    # serialized-step latency differs per algorithm.
    m = wire_bytes_model(algo, n, vector_bytes)
    base_steps = wire_bytes_model(
        {"all_gather": "ring_all_gather", "all_reduce": "ring_all_reduce",
         "all_to_all": "linear_all_to_all"}[kind], n, vector_bytes)["steps"]
    t = t + (m["steps"] - base_steps) * 2e-6
    return Prediction(algo, t, m["bytes"], m["steps"], "simulated")


def choose_schedule(kind: str, n: int, vector_bytes: float,
                    system: Optional[SystemPreset] = None,
                    profile: Optional[cong.Profile] = None,
                    aggressor: str = "",
                    use_simulator: bool = False, device=None) -> Prediction:
    """Pick the fastest candidate schedule for a collective."""
    preds: List[Prediction] = []
    for algo in CANDIDATES[kind]:
        if use_simulator and system is not None:
            preds.append(predict_simulated(kind, algo, n, vector_bytes,
                                           system, profile, aggressor,
                                           device=device))
        else:
            preds.append(predict_analytic(kind, algo, n, vector_bytes))
    return min(preds, key=lambda p: p.time_s)


# --------------------------------------------------------------------------
# pod-axis training-step strategy (compression / sharding) from roofline
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PodStrategy:
    compress_grads: bool
    predicted_collective_s: float
    predicted_baseline_s: float

    @property
    def speedup_on_collective_term(self) -> float:
        if self.predicted_collective_s == 0:
            return 1.0
        return self.predicted_baseline_s / self.predicted_collective_s


def choose_pod_strategy(grad_bytes_per_device: float, n_pods: int,
                        *, dcn_bw: float = 25e9, peak_flops: float = 197e12,
                        quant_flops_per_byte: float = 4.0,
                        compress_ratio: float = 3.9) -> PodStrategy:
    """Compression pays when wire time saved exceeds quantization compute.

    grad_bytes_per_device: pod-axis all-reduce payload (bf16 grads).
    """
    frac = (n_pods - 1) / max(n_pods, 1)
    t_base = 2 * frac * grad_bytes_per_device / dcn_bw
    t_wire = t_base / compress_ratio
    t_quant = quant_flops_per_byte * grad_bytes_per_device / peak_flops
    t_comp = t_wire + t_quant
    return PodStrategy(compress_grads=t_comp < t_base,
                       predicted_collective_s=min(t_comp, t_base),
                       predicted_baseline_s=t_base)
