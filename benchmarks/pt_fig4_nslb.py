"""Paper Fig. 4 on the port: NSLB on/off under steady AlltoAll congestion
(4 victim + 4 aggressor nodes on the Nanjing CE9855 leaf-spine).

``PYTHONPATH=src python -m benchmarks.pt_fig4_nslb [--quick] [--force]
[--device cpu]``
"""
from __future__ import annotations

import argparse

from benchmarks.pt_common import (cached_sweep, default_cache_dir,
                                  device_name, size_label)
from repro_torch.core import scenarios
from repro_torch.core.fabric.simulator import resolve_device


def run_points(points, device=None) -> list:
    """One row per ``(mode, vector_bytes)`` point, all points as one
    batched run (``scenarios.run_fig4_points``)."""
    device = resolve_device(device)
    rows = []
    for (mode, v), r in zip(points, scenarios.run_fig4_points(
            points, device=device)):
        v = float(v)
        rows.append({
            "gbps_uncongested": 8e-9 * v * (3 / 4) / r.t_uncongested_s,
            "gbps_congested": 8e-9 * v * (3 / 4) / r.t_congested_s,
            "ratio": r.ratio,
            "device": device_name(device),
        })
    return rows


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None):
    device = resolve_device(device)
    points = list(scenarios.get("fig4_nslb", quick).points)
    batch = {}

    def row(m, v):
        # the first point the cache lacks runs every point as one batch
        if not batch:
            batch.update(zip(points, run_points(points, device)))
        return batch[(m, v)]
    rows = cached_sweep("fig4_nslb", ["mode", "vector_bytes"], points, row,
                        cache_dir=cache_dir or default_cache_dir(device),
                        force=force)
    print("\n# Fig. 4 — NSLB under steady AlltoAll congestion (4+4 nodes)")
    print(f"{'mode':>6} {'size':>8} {'uncong Gb/s':>12} {'cong Gb/s':>10} "
          f"{'ratio':>6}")
    for r in rows:
        print(f"{r['mode']:>6} {size_label(r['vector_bytes']):>8} "
              f"{float(r['gbps_uncongested']):>12.0f} "
              f"{float(r['gbps_congested']):>10.0f} "
              f"{float(r['ratio']):>6.2f}")
    on = min(float(r["ratio"]) for r in rows if r["mode"] == "nslb")
    off = max(float(r["ratio"]) for r in rows if r["mode"] == "ecmp")
    print(f"# Fig.4 check: NSLB worst ratio {on:.2f} (paper: ~1.0), "
          f"ECMP best {off:.2f} (paper: ~0.67) -> "
          f"{'REPRODUCED' if on > 0.9 and off < 0.85 else 'MISMATCH'}")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, device=a.device)
