"""Path-assignment policies (paper §II load balancing).

Static (host-side, resolved ahead of time, numpy):

* ``deterministic`` — always the first candidate path (legacy IB static).
* ``ecmp``          — splitmix64 hash of (salt, src, dst).
* ``nslb``          — Network Scale Load Balance: greedy min-load
                      assignment over candidate paths, processed per
                      source so one source's flows spread across uplinks.

Per-cell (``SimParams.policy``, selected inside the simulator step):
``POLICY_FIXED`` replays the static assignment, ``POLICY_ECMP`` /
``POLICY_NSLB`` read those tables, ``POLICY_ADAPTIVE`` reroutes to the
least-occupied candidate with hysteresis, ``POLICY_FLOWLET`` re-picks
only after an idle gap.

:func:`splitmix64_hilo` is the same 64-bit mixer on tensors: torch has
almost no uint32/uint64 arithmetic, so the two 32-bit halves live in
int64 tensors and every intermediate is kept below 2**63.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

POLICY_FIXED = 0
POLICY_ECMP = 1
POLICY_NSLB = 2
POLICY_ADAPTIVE = 3
POLICY_FLOWLET = 4
N_POLICIES = 5

POLICY_NAMES: Dict[int, str] = {
    POLICY_FIXED: "fixed", POLICY_ECMP: "ecmp", POLICY_NSLB: "nslb",
    POLICY_ADAPTIVE: "adaptive", POLICY_FLOWLET: "flowlet",
}

# static_routing mode -> the per-cell policy that reproduces it
STATIC_MODE_POLICY: Dict[str, int] = {
    "deterministic": POLICY_FIXED, "ecmp": POLICY_ECMP, "nslb": POLICY_NSLB,
}

_U64 = np.uint64
_SPLITMIX_GAMMA = 0x9E3779B97F4A7C15
_SPLITMIX_M1 = 0xBF58476D1CE4E5B9
_SPLITMIX_M2 = 0x94D049BB133111EB
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def splitmix64(x) -> np.ndarray:
    """SplitMix64 finalizer on uint64 (scalars or arrays); all arithmetic
    wraps mod 2^64 by construction."""
    with np.errstate(over="ignore"):  # wrap-around IS the algorithm
        x = (np.asarray(x, _U64) + _U64(_SPLITMIX_GAMMA))
        x = (x ^ (x >> _U64(30))) * _U64(_SPLITMIX_M1)
        x = (x ^ (x >> _U64(27))) * _U64(_SPLITMIX_M2)
        return x ^ (x >> _U64(31))


def _mul32(a: torch.Tensor, b: int):
    """Full 64-bit product of a (< 2**32, int64 tensor) and a 32-bit
    constant, as (hi, lo) 32-bit halves: 16-bit limbs keep every partial
    product below 2**34."""
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    ll = a0 * b0
    mid = a0 * b1 + a1 * b0
    lo = ll + ((mid & _MASK16) << 16)
    hi = a1 * b1 + (mid >> 16) + (lo >> 32)
    return hi & _MASK32, lo & _MASK32


def _mul32_lo(a: torch.Tensor, b: int) -> torch.Tensor:
    """Low 32 bits of a * b (both < 2**32)."""
    return _mul32(a, b)[1]


def splitmix64_hilo(hi: torch.Tensor, lo: torch.Tensor):
    """:func:`splitmix64` on (hi, lo) 32-bit halves held in int64 tensors
    (values in [0, 2**32)). Returns the mixed (hi, lo) pair, bit-equal to
    the uint64 reference."""
    hi = hi.to(torch.int64) & _MASK32
    lo = lo.to(torch.int64) & _MASK32

    def add64(hi, lo, c):
        s = lo + (c & _MASK32)
        return (hi + (c >> 32) + (s >> 32)) & _MASK32, s & _MASK32

    def shr64_xor(hi, lo, k):
        s_lo = (lo >> k) | ((hi << (32 - k)) & _MASK32)
        return hi ^ (hi >> k), lo ^ s_lo

    def mul64(hi, lo, m):
        m_hi, m_lo = m >> 32, m & _MASK32
        p_hi, p_lo = _mul32(lo, m_lo)
        return (p_hi + _mul32_lo(lo, m_hi) + _mul32_lo(hi, m_lo)) \
            & _MASK32, p_lo

    hi, lo = add64(hi, lo, _SPLITMIX_GAMMA)
    hi, lo = shr64_xor(hi, lo, 30)
    hi, lo = mul64(hi, lo, _SPLITMIX_M1)
    hi, lo = shr64_xor(hi, lo, 27)
    hi, lo = mul64(hi, lo, _SPLITMIX_M2)
    hi, lo = shr64_xor(hi, lo, 31)
    return hi, lo


def ecmp_hash(src, dst, salt) -> np.ndarray:
    """Deterministic ECMP hash of (src, dst) under ``salt`` — two
    splitmix64 rounds so src and dst both avalanche."""
    s = np.asarray(src, _U64)
    d = np.asarray(dst, _U64)
    key = (splitmix64(_U64(salt)) << _U64(32)) ^ (s << _U64(1)) ^ d
    return splitmix64(splitmix64(key) ^ d)


def assign_paths(mode: str, flows_src_dst, paths_per_flow, n_links: int,
                 seed: int = 0) -> np.ndarray:
    F = len(paths_per_flow)
    choice = np.zeros((F,), np.int32)
    if mode == "deterministic":
        return choice
    if mode == "ecmp":
        if F == 0:
            return choice
        src = np.array([s for s, _ in flows_src_dst], np.uint64)
        dst = np.array([d for _, d in flows_src_dst], np.uint64)
        n = np.maximum([len(p) for p in paths_per_flow], 1).astype(np.uint64)
        return (ecmp_hash(src, dst, seed) % n).astype(np.int32)
    if mode == "nslb":
        # flow-matrix style: greedy min-max link usage, grouped by source so
        # one source's concurrent flows land on distinct uplinks.
        usage = np.zeros((n_links + 1,), np.int64)
        order = sorted(range(F), key=lambda f: (flows_src_dst[f][0],
                                                flows_src_dst[f][1]))
        for f in order:
            ps = paths_per_flow[f]
            if not ps:
                continue
            best_k, best_cost = 0, None
            for k, p in enumerate(ps):
                cost = (max((usage[l] for l in p), default=0),
                        sum(usage[l] for l in p))
                if best_cost is None or cost < best_cost:
                    best_k, best_cost = k, cost
            choice[f] = best_k
            for l in ps[best_k]:
                usage[l] += 1
        return choice
    raise KeyError(mode)
