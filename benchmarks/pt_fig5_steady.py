"""Paper Fig. 5 / Obs. 2 on the port: steady congestion at scale — ratio
heatmaps (nodes x vector size) per system x aggressor, AllGather victim.
Each (system, aggressor, nodes) grid runs as one batched run over its
vector sizes.

``PYTHONPATH=src python -m benchmarks.pt_fig5_steady [--quick] [--force]
[--device cpu]``
"""
from __future__ import annotations

import argparse

from benchmarks.pt_common import (default_cache_dir, heatmap, scenario_rows,
                                  size_label)
from repro_torch.core import scenarios
from repro_torch.core.fabric.simulator import resolve_device

SYSTEMS = scenarios.FIG5_SYSTEMS
AGGRESSORS = scenarios.FIG5_AGGRESSORS


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None):
    device = resolve_device(device)
    rows = scenario_rows(scenarios.get("fig5_steady", quick), device=device,
                         cache_dir=cache_dir or default_cache_dir(device),
                         force=force)
    for s in SYSTEMS:
        for a in AGGRESSORS:
            sub = [r for r in rows
                   if r["system"] == s and r["aggressor"] == a]
            if not sub:
                continue
            for r in sub:
                r["size"] = size_label(r["vector_bytes"])
            print(f"\n# Fig. 5 — {s}, {a} aggressor "
                  "(uncongested/congested ratio; higher is better)")
            print(heatmap(sub, x="n_nodes", y="size", val="ratio"))
    get = lambda s, a: min(float(r["ratio"]) for r in rows  # noqa: E731
                           if r["system"] == s and r["aggressor"] == a)
    print("\n# Obs.2 checks (worst cell per system x aggressor):")
    print(f"#  lumi     a2a {get('lumi', 'alltoall'):.2f} / "
          f"incast {get('lumi', 'incast'):.2f}   (paper: ~1.0 both)")
    print(f"#  leonardo a2a {get('leonardo', 'alltoall'):.2f} / "
          f"incast {get('leonardo', 'incast'):.2f}   (paper: >=0.82 / ~0.2)")
    print(f"#  cresco8  a2a {get('cresco8', 'alltoall'):.2f} / "
          f"incast {get('cresco8', 'incast'):.2f}   (paper: ~0.45 / ~0.6)")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, device=a.device)
