"""Paper Fig. 7 (CRESCO8, 128 nodes) and Fig. 8 (LUMI, 256 nodes) on the
port: bursty congestion at larger scale, with the paper's 64 vs 128-node
CRESCO8 incast comparison (a wider congestion tree collapses less).

Each aggressor's whole (system x n_nodes) ladder runs as one
``bench.run_scale_grid`` call: the geometries padded into one bucket, every
cell x size x (burst, pause) sub-cell one batch, one launch of each kernel
a step. The script reports the engine's steps and kernel-1 launches and
the buckets it ran; ``--compare`` also times the per-geometry loop (one
``run_grid`` a cell) against the batched call.

``PYTHONPATH=src python -m benchmarks.pt_fig7_fig8_scale [--quick]
[--force] [--compare] [--device cpu] [--cache-dir DIR]``
"""
from __future__ import annotations

import argparse
import time

from benchmarks.pt_common import default_cache_dir, heatmap, scenario_rows
from repro_torch.core import scenarios
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.kernels import fabric_step


def run_sequential(scenario, device) -> float:
    """One run_grid a (system, n_nodes) cell, timed (results dropped)."""
    from repro_torch.core import bench
    from repro_torch.core.fabric import systems

    t0 = time.time()
    for grid in scenario.grids:
        for s, n in grid.cells:
            bench.run_grid(systems.get_system(s), int(n), grid.victim,
                           grid.aggressor, grid.sizes, grid.profiles,
                           n_iters=scenario.n_iters, warmup=scenario.warmup,
                           device=device)
    return time.time() - t0


def run_batched(scenario, device) -> float:
    """One scale-batched call a grid, timed fresh (no CSV cache)."""
    t0 = time.time()
    for grid in scenario.grids:
        scenarios.run_grid_spec(scenario, grid, device=device)
    return time.time() - t0


def worst_ratio(rows, system: str, n_nodes: int, aggressor: str) -> float:
    sub = [float(r["ratio"]) for r in rows if r["system"] == system
           and int(r["n_nodes"]) == n_nodes and r["aggressor"] == aggressor]
    return min(sub) if sub else float("nan")


def main(force: bool = False, quick: bool = False, compare: bool = False,
         device=None, cache_dir=None):
    device = resolve_device(device)
    scenario = scenarios.get("fig7_fig8_scale", quick)
    cells = []
    for grid in scenario.grids:
        cells += [c for c in grid.cells if c not in cells]
    steps0, launches0 = sim.step_count, fabric_step.launches
    t0 = time.time()
    rows = scenario_rows(scenario, device=device,
                         cache_dir=cache_dir or default_cache_dir(device),
                         force=force)
    wall = time.time() - t0
    steps = sim.step_count - steps0
    launches = fabric_step.launches - launches0

    for s, n in cells:
        for a in ("alltoall", "incast"):
            sub = [r for r in rows if r["system"] == s
                   and int(r["n_nodes"]) == n and r["aggressor"] == a]
            if not sub:
                continue
            print(f"\n# Fig. 7/8 — {s} {n} nodes, {a} aggressor (rows: "
                  "burst ms, cols: pause ms; ratio over sizes=min)")
            best = {}
            for r in sub:
                k = (r["burst_ms"], r["pause_ms"])
                best[k] = min(best.get(k, 1e9), float(r["ratio"]))
            flat = [{"burst_ms": b, "pause_ms": p, "ratio": v}
                    for (b, p), v in best.items()]
            print(heatmap(flat, x="pause_ms", y="burst_ms", val="ratio"))
    # paper: CRESCO8 incast bursts hurt less at 128 nodes than at 64
    w64 = worst_ratio(rows, "cresco8", 64, "incast")
    w128 = worst_ratio(rows, "cresco8", 128, "incast")
    if w64 == w64 and w128 == w128:
        print(f"\n# Fig.7 check: cresco8 incast worst ratio 64n={w64:.3f} "
              f"vs 128n={w128:.3f} (paper: 128 nodes less affected) -> "
              f"{'REPRODUCED' if w128 > w64 else 'MISMATCH'}")
    lumi = [float(r["ratio"]) for r in rows if r["system"] == "lumi"]
    if lumi:
        print(f"# Fig.8 check: LUMI worst ratio {min(lumi):.3f} (paper: "
              f"near-baseline everywhere) -> "
              f"{'REPRODUCED' if min(lumi) > 0.85 else 'MISMATCH'}")
    print(f"\n# scale-batched engine: {len(scenario.grids)} bucket(s) for "
          f"{len(cells) * len(scenario.grids)} (system x scale x aggressor) "
          f"cells in {wall:.1f}s, {steps} engine steps, {launches} kernel-1 "
          "launches" + (" (all rows cached)" if steps == 0 else ""))
    if compare:
        t_batched = run_batched(scenario, device)
        t_seq = run_sequential(scenario, device)
        print(f"# --compare: batched {t_batched:.1f}s vs per-geometry loop "
              f"{t_seq:.1f}s -> {t_seq / max(t_batched, 1e-9):.2f}x")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--compare", action="store_true",
                   help="also time the per-geometry loop against the "
                        "batched call")
    p.add_argument("--device", default=None)
    p.add_argument("--cache-dir", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, compare=a.compare, device=a.device,
         cache_dir=a.cache_dir)
