"""Paper Fig. 3 / Obs. 1 on the port: CE8850 self-congestion sawtooth on
large-message AllGather; EDR InfiniBand (same nodes) and CE9855 stay
stable. Each point is one aggressor-free run whose victim goodput trace
is cut as ``benchmarks/fig3_sawtooth.py`` cuts it: the first third
dropped, then the zero samples; all points run as one batch
(``bench.goodput_traces``).

``PYTHONPATH=src python -m benchmarks.pt_fig3_sawtooth [--quick]
[--force] [--device cpu]``
"""
from __future__ import annotations

import argparse

import numpy as np

from benchmarks.pt_common import (cached_sweep, default_cache_dir,
                                  device_name, size_label)
from repro_torch.core import bench, scenarios
from repro_torch.core.fabric import systems
from repro_torch.core.fabric.simulator import resolve_device

SYSTEMS = ("haicgu_ce8850", "haicgu_ib", "nanjing_nslb")
N_NODES = 4
COLLECTIVE = "ring_allgather"
# Obs. 1 holds when the CE8850's worst CV exceeds this multiple of the
# other systems' worst
OBS1_FACTOR = 2.5


def _spark(tr: np.ndarray, width: int = 64) -> str:
    if len(tr) == 0:
        return ""
    idx = np.linspace(0, len(tr) - 1, width).astype(int)
    t = tr[idx]
    lo, hi = t.min(), t.max()
    blocks = "▁▂▃▄▅▆▇█"
    span = max(hi - lo, 1e-9)
    return "".join(blocks[int((v - lo) / span * 7.999)] for v in t)


def steady_part(trace: np.ndarray) -> np.ndarray:
    """The goodput samples Fig. 3 reads: after the first third, nonzero."""
    tr = np.asarray(trace)[len(trace) // 3:]
    return tr[tr > 0]


def run_points(points, device=None) -> list:
    """One row per ``(system, vector_bytes)`` point, every point's trace a
    cell of one batched run (``bench.goodput_traces``)."""
    device = resolve_device(device)
    results = bench.goodput_traces(trace_points(points), n_iters=25,
                                   device=device)
    rows = []
    for res in results:
        tr = steady_part(res.victim_rate_trace)
        rows.append({
            "goodput_gbps": float(tr.mean() * 8 / 1e9) if len(tr) else 0.0,
            "cv": float(tr.std() / tr.mean()) if len(tr) else 0.0,
            "trace_len": len(tr),
            "n_iters": res.n_done,
            "spark": _spark(tr),
            "device": device_name(device),
        })
    return rows


def trace_points(points) -> list:
    """``(system, vector_bytes)`` points as the ``(preset, n_nodes, coll,
    vector_bytes)`` points of bench.goodput_traces / goodput_inputs."""
    return [(systems.get_system(s), N_NODES, COLLECTIVE, float(v))
            for s, v in points]


def obs1(rows) -> tuple:
    """(CE8850's worst CV, the others' worst CV, sawtooth reproduced)."""
    ce = max(float(r["cv"]) for r in rows if r["system"] == "haicgu_ce8850")
    others = max(float(r["cv"]) for r in rows
                 if r["system"] != "haicgu_ce8850")
    return ce, others, ce > OBS1_FACTOR * others


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None):
    device = resolve_device(device)
    points = list(scenarios.get("fig3_sawtooth", quick).points)
    batch = {}

    def row(s, v):
        # the first point the cache lacks runs every point as one batch
        if not batch:
            batch.update(zip(points, run_points(points, device)))
        return batch[(s, v)]
    rows = cached_sweep("fig3_sawtooth", ["system", "vector_bytes"], points,
                        row, cache_dir=cache_dir or default_cache_dir(device),
                        force=force)
    print("\n# Fig. 3 — self-congestion stability, 4-node AllGather")
    print(f"{'system':>16} {'size':>8} {'Gb/s':>7} {'CV':>6}  goodput trace")
    for r in rows:
        print(f"{r['system']:>16} {size_label(r['vector_bytes']):>8} "
              f"{float(r['goodput_gbps']):>7.0f} {float(r['cv']):>6.3f}  "
              f"{r['spark']}")
    ce, others, ok = obs1(rows)
    print(f"# Obs.1 check: CE8850 CV {ce:.3f} vs others max {others:.3f} "
          f"-> sawtooth {'REPRODUCED' if ok else 'ABSENT'}")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, device=a.device)
