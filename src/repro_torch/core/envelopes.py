"""Parameterized congestion envelopes (paper §III-C/D, extended).

An envelope modulates aggressor injection intensity over simulated time.
It is data: up to :data:`ENV_COMPONENTS` weighted component rows
``[kind, p0, p1, weight, seed]`` evaluated by :func:`envelope_at`, a
tensor function of sim time batched over cells, so one batched run can
mix steady, bursty, ramp, random-telegraph and multi-tenant cells.

* ``off``     — 0 everywhere (baseline runs).
* ``steady``  — 1 everywhere (§III-C).
* ``bursty``  — square wave, ``p0`` seconds on / ``p1`` seconds off (§III-D).
* ``ramp``    — linear onset 0 -> 1 over ``p0`` seconds, then hold.
* ``random``  — random telegraph: slots of length ``p0`` are on with
  probability ``p0/(p0+p1)`` via a splitmix64 counter hash.

Component weights sum the contributions and the result is clipped to
[0, 1]. Every component is evaluated in float32, so :func:`envelope_at`
and the numpy mirror :func:`envelope_np` agree bit for bit.

A fault table (:func:`fault_table`) is the per-link counterpart: up to
:data:`FAULT_EVENTS` rows ``[kind, t_start, duration, severity,
link_group, seed]`` (outages, flapping links, dying optics, jitter) that
:func:`fault_scale_at` lowers, per cell and step, to a capacity scale in
[FAULT_FLOOR, 1] on the links of the targeted structural groups. The
simulator step multiplies the link capacities by it before kernel 1's
launch. An all-``none`` table lowers to exactly 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .fabric.routing import splitmix64, splitmix64_hilo

ENV_OFF = 0
ENV_STEADY = 1
ENV_BURSTY = 2
ENV_RAMP = 3
ENV_RANDOM = 4

ENV_COMPONENTS = 4  # fixed component slots per envelope

_KIND_IDS = {"off": ENV_OFF, "steady": ENV_STEADY, "bursty": ENV_BURSTY,
             "ramp": ENV_RAMP, "random": ENV_RANDOM}


def _py_mod(x: torch.Tensor, y) -> torch.Tensor:
    """Floored float modulo computed exactly (``fmod`` plus a sign fix),
    as numpy's ``%`` does; ``torch.remainder`` rounds ``x - y*floor(x/y)``
    and can differ in the last bit."""
    r = torch.fmod(x, y)
    y = torch.as_tensor(y, dtype=r.dtype, device=r.device)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def envelope_at(env: torch.Tensor, t: torch.Tensor,
                with_random: bool = True) -> torch.Tensor:
    """Envelope value in [0, 1] per cell. ``env`` is (B, ENV_COMPONENTS,
    5) float32, ``t`` (B,) float32; returns (B,) float32.

    ``with_random=False`` skips the telegraph hash; the caller promises
    that no row of ``env`` is a ``random`` component, whose value is the
    only one that reads it."""
    kind = env[..., 0].to(torch.int32)
    p0, p1, w, seed = env[..., 1], env[..., 2], env[..., 3], env[..., 4]
    t = t[:, None]
    period = torch.clamp_min(p0 + p1, 1e-12)
    slot_len = torch.clamp_min(p0, 1e-12)
    on_bursty = (_py_mod(t, period) < p0).to(torch.float32)
    on_ramp = torch.clamp(t / slot_len, 0.0, 1.0)
    if with_random:
        # mod before the cast: off/steady rows leave slot_len at its 1e-12
        # floor, whose huge quotient would otherwise leave the 32-bit range
        slot = _py_mod(torch.floor(t / slot_len), 2.0 ** 32).to(torch.int64)
        h_hi, _ = splitmix64_hilo(seed.to(torch.int64), slot)
        u = ((h_hi >> 8) & 0xFFFFFF).to(torch.float32) / float(0x1000000)
        on_random = (u < p0 / period).to(torch.float32)
    else:
        on_random = torch.zeros_like(on_ramp)
    val = torch.where(kind == ENV_STEADY, torch.ones_like(on_ramp),
          torch.where(kind == ENV_BURSTY, on_bursty,  # noqa: E128
          torch.where(kind == ENV_RAMP, on_ramp,  # noqa: E128
          torch.where(kind == ENV_RANDOM, on_random,  # noqa: E128
                      torch.zeros_like(on_ramp)))))
    wv = w * val
    # components summed left to right, as the reference reduction does
    total = wv[:, 0]
    for c in range(1, wv.shape[1]):
        total = total + wv[:, c]
    return torch.clamp(total, 0.0, 1.0)


def envelope_np(env: np.ndarray, t: np.ndarray) -> np.ndarray:
    """NumPy mirror of :func:`envelope_at` for one envelope, vectorized
    over a time array; float32 throughout so slot indices and telegraph
    bins match the tensor path bit for bit."""
    t = np.asarray(t, np.float32)[..., None]  # (..., 1) vs (C,) components
    env = np.asarray(env, np.float32)
    kind = env[:, 0].astype(np.int64)
    p0, p1, w, seed = env[:, 1], env[:, 2], env[:, 3], env[:, 4]
    period = np.maximum(p0 + p1, np.float32(1e-12))
    slot_len = np.maximum(p0, np.float32(1e-12))
    on_bursty = ((t % period) < p0).astype(np.float32)
    on_ramp = np.clip(t / slot_len, np.float32(0), np.float32(1))
    slot = np.mod(np.floor(t / slot_len),
                  np.float32(2.0 ** 32)).astype(np.uint64)
    key = (seed.astype(np.uint64) << np.uint64(32)) | slot
    h_hi = splitmix64(key) >> np.uint64(32)
    u = ((h_hi >> np.uint64(8)) & np.uint64(0xFFFFFF)).astype(np.float32) \
        / np.float32(0x1000000)
    on_random = (u < p0 / period).astype(np.float32)
    val = np.select(
        [kind == ENV_STEADY, kind == ENV_BURSTY, kind == ENV_RAMP,
         kind == ENV_RANDOM],
        [np.ones_like(on_ramp), on_bursty, on_ramp, on_random],
        np.float32(0))
    return np.clip((w * val).sum(-1, dtype=np.float32),
                   np.float32(0), np.float32(1))


# --------------------------------------------------------------------------
# Per-link fault envelopes (flapping links, dying optics)
# --------------------------------------------------------------------------

FAULT_NONE = 0     # inert row
FAULT_OUTAGE = 1   # hard capacity drop inside [t_start, t_start+duration)
FAULT_FLAP = 2     # random telegraph: slots down with prob `severity`
FAULT_DEGRADE = 3  # dying optic: linear decay over `duration`, persists
FAULT_JITTER = 4   # per-slot random capacity wobble inside the window

FAULT_EVENTS = 8   # fixed event slots per table
FAULT_FIELDS = 6   # [kind, t_start, duration, severity, link_group, seed]

# capacity scale floor: queueing delays divide by the scaled capacity, so
# a fault never lowers a link to exactly 0
FAULT_FLOOR = 2.0 ** -10

# telegraph slot length of flap and jitter events (seconds)
FLAP_SLOT_S = 250e-6

# structural link groups (values of FabricGeometry.link_group)
GROUP_NONE = 0
GROUP_EDGE_UP = 1    # host -> leaf switch (injection edge)
GROUP_EDGE_DOWN = 2  # leaf switch -> host (delivery edge)
GROUP_FABRIC = 3     # switch -> switch
GROUP_HOT = 4        # the single most-traversed link
GROUP_SWITCH = 5     # every link of the busiest switch (link_sw_group)

_FAULT_IDS = {"none": FAULT_NONE, "outage": FAULT_OUTAGE,
              "flap": FAULT_FLAP, "degrade": FAULT_DEGRADE,
              "jitter": FAULT_JITTER}
_GROUP_LABELS = {GROUP_NONE: "none", GROUP_EDGE_UP: "up",
                 GROUP_EDGE_DOWN: "down", GROUP_FABRIC: "fab",
                 GROUP_HOT: "hot", GROUP_SWITCH: "sw"}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault-event row; ``severity`` is the fraction of capacity lost
    (outage/degrade), the slot down-probability (flap), or the wobble
    amplitude (jitter)."""

    kind: str  # "outage" | "flap" | "degrade" | "jitter"
    t_start: float
    duration: float
    severity: float
    link_group: int = GROUP_HOT
    seed: int = 1

    def label(self) -> str:
        g = _GROUP_LABELS.get(self.link_group, str(self.link_group))
        return (f"{self.kind}[{g} {self.severity:g} "
                f"@{self.t_start * 1e3:g}+{self.duration * 1e3:g}ms]")


def outage(t_start: float, duration: float, severity: float = 1.0,
           link_group: int = GROUP_HOT, seed: int = 1) -> FaultEvent:
    """Hard capacity loss for the window (severity 1.0 = link down)."""
    return FaultEvent("outage", t_start, duration, severity, link_group, seed)


def flap(t_start: float, duration: float, duty: float = 0.3,
         link_group: int = GROUP_HOT, seed: int = 1) -> FaultEvent:
    """Flapping link: FLAP_SLOT_S slots inside the window go down (to
    FAULT_FLOOR) with probability ``duty`` via the counter hash."""
    return FaultEvent("flap", t_start, duration, duty, link_group, seed)


def degrade(t_start: float, duration: float, severity: float = 0.8,
            link_group: int = GROUP_HOT, seed: int = 1) -> FaultEvent:
    """Dying optic: capacity decays linearly to ``1 - severity`` over
    ``duration`` and stays degraded afterwards."""
    return FaultEvent("degrade", t_start, duration, severity,
                      link_group, seed)


def jitter(t_start: float, duration: float, severity: float = 0.5,
           link_group: int = GROUP_FABRIC, seed: int = 1) -> FaultEvent:
    """Per-slot uniform capacity wobble in [1-severity, 1] inside the
    window."""
    return FaultEvent("jitter", t_start, duration, severity,
                      link_group, seed)


def switch_outage(t_start: float, duration: float, severity: float = 1.0,
                  seed: int = 1) -> FaultEvent:
    """The busiest switch loses (a fraction of) every incident link for
    the window: GROUP_SWITCH, matched against ``link_sw_group``."""
    return FaultEvent("outage", t_start, duration, severity,
                      GROUP_SWITCH, seed)


def fault_table(events=()) -> np.ndarray:
    """Lower events to the fixed (FAULT_EVENTS, FAULT_FIELDS) table;
    unused rows are ``none``."""
    events = tuple(events)
    if len(events) > FAULT_EVENTS:
        raise ValueError(
            f"{len(events)} fault events exceed {FAULT_EVENTS} slots")
    rows = np.zeros((FAULT_EVENTS, FAULT_FIELDS), np.float32)
    for i, e in enumerate(events):
        rows[i] = (_FAULT_IDS[e.kind], e.t_start, e.duration, e.severity,
                   e.link_group, e.seed)
    return rows


def no_fault_table() -> np.ndarray:
    """The all-``none`` table: its scale is exactly 1.0 on every link, so
    capacities multiplied by it keep their bits. Grids put it on the cells
    without faults when another cell has some."""
    return fault_table(())


def fault_rows(fault: torch.Tensor) -> list:
    """The event slots that are not ``none`` in some cell of a (B,
    FAULT_EVENTS, FAULT_FIELDS) table, in slot order (host side)."""
    kinds = fault[..., 0].cpu().to(torch.int32)
    return [e for e in range(kinds.shape[-1])
            if bool((kinds[:, e] != FAULT_NONE).any())]


def fault_scale_at(fault: torch.Tensor, link_group: torch.Tensor,
                   t: torch.Tensor, link_sw_group: torch.Tensor = None,
                   rows=None) -> torch.Tensor:
    """Per-link capacity scale at sim time ``t`` per cell.

    ``fault`` is (B, FAULT_EVENTS, FAULT_FIELDS) float32, ``link_group``
    and ``link_sw_group`` (B or 1, L+1) structural group ids and ``t``
    (B,) float32; returns (B, L+1) float32 in [FAULT_FLOOR, 1]. A row
    matches a link through either group array. Matching rows multiply in
    slot order (rows that match nowhere contribute an exact 1.0), so the
    result equals the reference's product bit for bit wherever at most
    two non-unit factors meet on a link. ``rows`` (:func:`fault_rows`)
    names the slots to evaluate; slots that are ``none`` in every cell
    scale nothing and may be left out."""
    if rows is None:
        rows = range(fault.shape[1])
    B, L1 = t.shape[0], link_group.shape[-1]
    out = torch.ones((B, L1), dtype=torch.float32, device=t.device)
    if not len(rows):
        return out
    f = fault[:, list(rows)]
    kind = f[..., 0].to(torch.int32)
    t0, dur, sev = f[..., 1], f[..., 2], f[..., 3]
    grp = f[..., 4].to(torch.int32)
    rel = t[:, None] - t0
    in_win = (rel >= 0.0) & (rel < dur)
    # telegraph slot of flap and jitter rows, in float32 throughout: the
    # slot length rounded to float32 first and a true division (a
    # float64 quotient, or a product with the reciprocal, can floor into
    # the next slot); rel clamped to >= 0 so the quotient stays in range
    slot_s = torch.tensor(FLAP_SLOT_S, dtype=torch.float32, device=t.device)
    slot = _py_mod(torch.floor(torch.clamp_min(rel, 0.0) / slot_s),
                   2.0 ** 32).to(torch.int64)
    h_hi, _ = splitmix64_hilo(f[..., 5].to(torch.int64), slot)
    u = ((h_hi >> 8) & 0xFFFFFF).to(torch.float32) / float(0x1000000)
    one = torch.ones_like(sev)
    ramp_in = torch.clamp(rel / torch.clamp_min(dur, 1e-9), 0.0, 1.0)
    s = torch.where(kind == FAULT_OUTAGE, torch.where(in_win, 1.0 - sev, one),
        torch.where(kind == FAULT_FLAP,  # noqa: E128
                    torch.where(in_win & (u < sev), 0.0, one),
        torch.where(kind == FAULT_DEGRADE,  # noqa: E128
                    torch.where(rel >= 0.0, 1.0 - sev * ramp_in, one),
        torch.where(kind == FAULT_JITTER,  # noqa: E128
                    torch.where(in_win, 1.0 - sev * u, one), one))))
    s = torch.clamp_min(s, FAULT_FLOOR)
    live = (kind != FAULT_NONE)[..., None]
    lg = link_group.to(torch.int32)[:, None, :]
    match = (grp[..., None] == lg) & live & (lg != GROUP_NONE)
    if link_sw_group is not None:
        sg = link_sw_group.to(torch.int32)[:, None, :]
        match = match | ((grp[..., None] == sg) & live & (sg != GROUP_NONE))
    for e in range(len(rows)):
        out = out * torch.where(match[:, e], s[:, e, None], 1.0)
    return out


# --------------------------------------------------------------------------
# Declarative profile objects
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Profile:
    """A named congestion profile; ``params()`` lowers it to the component
    table the simulator consumes."""

    kind: str  # "off" | "steady" | "bursty" | "ramp" | "random" | "mix"
    burst_s: float = 0.0
    pause_s: float = 0.0
    seed: int = 0
    components: Tuple[Tuple["Profile", float], ...] = ()
    faults: Tuple[FaultEvent, ...] = ()
    # intra-node stage capacity as a fraction of the NIC rate; 0 = inert
    node_cap_frac: float = 0.0

    def params(self) -> np.ndarray:
        rows = np.zeros((ENV_COMPONENTS, 5), np.float32)
        if self.kind == "mix":
            if not self.components:
                raise ValueError(
                    "mix profile with zero components would silently "
                    "lower to an all-off table; use no_congestion() for "
                    "an intentionally idle aggressor")
            comps = self.components
        else:
            comps = ((self, 1.0),)
        if len(comps) > ENV_COMPONENTS:
            raise ValueError(
                f"mix of {len(comps)} components exceeds {ENV_COMPONENTS}")
        for i, (prof, w) in enumerate(comps):
            if prof.kind == "mix":
                raise ValueError("nested mixes are not supported")
            rows[i] = (_KIND_IDS[prof.kind], prof.burst_s, prof.pause_s,
                       w, prof.seed)
        return rows

    def fault_params(self):
        """(FAULT_EVENTS, FAULT_FIELDS) table, or None without events."""
        return fault_table(self.faults) if self.faults else None

    def _base_label(self) -> str:
        if self.kind in ("off", "steady"):
            return self.kind
        if self.kind == "bursty":
            base = f"bursty {self.burst_s * 1e3:g}/{self.pause_s * 1e3:g}ms"
            if self.burst_s <= 0:
                base += "(=off)"
            elif self.pause_s <= 0:
                base += "(=on)"
            return base
        if self.kind == "ramp":
            base = f"ramp {self.burst_s * 1e3:g}ms"
            return base + ("(=step)" if self.burst_s <= 0 else "")
        if self.kind == "random":
            base = (f"random {self.burst_s * 1e3:g}/"
                    f"{self.pause_s * 1e3:g}ms s{self.seed}")
            if self.burst_s <= 0:
                base += "(=off)"
            elif self.pause_s <= 0:
                base += "(=on)"
            return base
        parts = ", ".join(f"{w:g}*{p.label()}" for p, w in self.components)
        if self.components and not any(w for _, w in self.components):
            return f"mix({parts})(=off)"
        return f"mix({parts})"

    def label(self) -> str:
        out = self._base_label()
        if self.faults:
            out += "+" + ",".join(e.label() for e in self.faults)
        if self.node_cap_frac > 0:
            out += f"+node{self.node_cap_frac:g}x"
        return out


def steady() -> Profile:
    return Profile("steady")


def bursty(burst_s: float, pause_s: float) -> Profile:
    return Profile("bursty", burst_s, pause_s)


def no_congestion() -> Profile:
    return Profile("off")


def ramp(ramp_s: float) -> Profile:
    """Aggressors linearly ramp from idle to full blast over ``ramp_s``."""
    return Profile("ramp", ramp_s)


def random_onoff(burst_s: float, pause_s: float, seed: int = 1) -> Profile:
    """Random telegraph with the same mean duty cycle as bursty(b, p)."""
    return Profile("random", burst_s, pause_s, seed=seed)


def multi_tenant(*weighted: Tuple[Profile, float]) -> Profile:
    """Weighted blend of tenant envelopes."""
    return Profile("mix", components=tuple(weighted))


def with_faults(profile: Profile, *events: FaultEvent) -> Profile:
    """The profile with link-fault events appended to its lane."""
    return dataclasses.replace(profile,
                               faults=tuple(profile.faults) + tuple(events))


def with_node_cap(profile: Profile, frac: float) -> Profile:
    """The profile with the intra-node stage armed at ``frac`` x the NIC
    rate (NVLink/PCIe contention ahead of the NIC)."""
    return dataclasses.replace(profile, node_cap_frac=float(frac))


def needs_fault_table(profiles) -> bool:
    """True when any lane of a grid carries fault events: then every lane
    carries a table (the inert one if need be) so the cells stack."""
    return any(p.faults for p in profiles)
