"""Paper Fig. 6 / Obs. 3 on the port: bursty congestion at 64 nodes — 3x3
heatmaps of (burst length x inter-burst pause) per system x aggressor x
vector size. Each (system, aggressor) grid runs as one batched run over
its sizes x (burst, pause) cells.

``PYTHONPATH=src python -m benchmarks.pt_fig6_bursty [--quick] [--force]
[--device cpu]``
"""
from __future__ import annotations

import argparse
import dataclasses

from benchmarks.pt_common import (default_cache_dir, heatmap, scenario_rows,
                                  size_label)
from repro_torch.core import scenarios
from repro_torch.core.fabric.simulator import resolve_device

SYSTEMS = scenarios.FIG5_SYSTEMS
AGGRESSORS = scenarios.FIG5_AGGRESSORS
SIZES = scenarios.FIG6_SIZES
N_NODES = 64


def grid_at_size(system: str, aggressor: str, vector_bytes: float,
                 quick: bool = False) -> scenarios.Grid:
    """The registry's Fig. 6 grid of (system, aggressor), cut to one
    vector size: its whole burst x pause table at that size."""
    grid = next(g for g in scenarios.get("fig6_bursty", quick).grids
                if (g.system, g.aggressor) == (system, aggressor))
    return dataclasses.replace(grid, sizes=(vector_bytes,))


def short_vs_long_pause(rows, system: str) -> "tuple | None":
    """Obs. 3 at the shortest burst length of ``system``'s incast rows:
    (burst ms, worst ratio at the shortest pause, at the longest pause).
    At the longest bursts the duty cycle is >= 50% for every pause and the
    fabric never drains, so the pause sensitivity saturates there (the
    flat bottom heatmap row, which the paper also shows)."""
    sub = [r for r in rows if r["system"] == system
           and r["aggressor"] == "incast"]
    if not sub:
        return None
    b0 = min(float(x["burst_ms"]) for x in sub)
    row = [r for r in sub if float(r["burst_ms"]) == b0]
    p_lo = min(float(x["pause_ms"]) for x in row)
    p_hi = max(float(x["pause_ms"]) for x in row)
    short = min(float(r["ratio"]) for r in row
                if float(r["pause_ms"]) == p_lo)
    longp = min(float(r["ratio"]) for r in row
                if float(r["pause_ms"]) == p_hi)
    return b0, short, longp


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None):
    device = resolve_device(device)
    sizes = (32 * 2 ** 10,) if quick else SIZES
    rows = scenario_rows(scenarios.get("fig6_bursty", quick), device=device,
                         cache_dir=cache_dir or default_cache_dir(device),
                         force=force)
    for s in SYSTEMS:
        for a in AGGRESSORS:
            for v in sizes:
                sub = [r for r in rows if r["system"] == s
                       and r["aggressor"] == a
                       and float(r["vector_bytes"]) == float(v)]
                if not sub:
                    continue
                print(f"\n# Fig. 6 — {s}, {a} aggressor, "
                      f"{size_label(v)} victim AllGather, {N_NODES} nodes "
                      "(rows: burst ms, cols: pause ms)")
                print(heatmap(sub, x="pause_ms", y="burst_ms", val="ratio"))
    # Obs. 3: short pauses hurt more than long pauses
    for s in ("cresco8", "leonardo"):
        cmp = short_vs_long_pause(rows, s)
        if cmp is None:
            continue
        b0, short, longp = cmp
        print(f"# Obs.3 {s} ({b0}ms bursts): ratio short-pause {short:.2f} "
              f"vs long-pause {longp:.2f} -> "
              f"{'REPRODUCED' if short < longp else 'MISMATCH'}")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, device=a.device)
