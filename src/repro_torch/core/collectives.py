"""Analytic wire-byte model of the collective schedules.

The schedules themselves (ring AllGather/AllReduce, AlltoAll, incast over
point-to-point sends) are not ported yet; the traffic compiler only needs
the analytic model to validate the phase programs it lowers.
"""
from __future__ import annotations


def wire_bytes_model(kind: str, n: int, vector_bytes: float) -> dict:
    """Per-rank wire bytes + serialized step count for each schedule."""
    v = float(vector_bytes)
    if n <= 1:
        return {"bytes": 0.0, "steps": 0}
    if kind == "ring_all_gather":
        return {"bytes": (n - 1) / n * v, "steps": n - 1}
    if kind == "bidir_ring_all_gather":
        return {"bytes": (n - 1) / n * v, "steps": (n - 1 + 1) // 2}
    if kind == "ring_all_reduce":
        return {"bytes": 2 * (n - 1) / n * v, "steps": 2 * (n - 1)}
    if kind in ("linear_all_to_all", "pairwise_all_to_all"):
        return {"bytes": (n - 1) / n * v,
                "steps": 1 if kind == "linear_all_to_all" else n - 1}
    if kind == "incast":
        return {"bytes": v, "steps": n - 1}
    raise KeyError(kind)
