"""Benchmark orchestrator of the port — one reproduction per paper figure,
as ``benchmarks/run.py`` is for the JAX package.

``PYTHONPATH=src python -m benchmarks.pt_run [--quick] [--force]
[--only fig1,fig3] [--device cpu] [--cache-dir DIR]``

Runs on the CUDA device unless ``--device`` names another; without a card
the default fails. By default it runs every ported benchmark: the paper's
figures (fig1, fig3, fig4, fig5, fig6, fig7_fig8), the beyond-paper
families (scenarios), the link-fault and intra-node families with their
engine checks, mitigation panel and monitor demo (faults), the fleet
replay (fleet_replay), the mitigation lab with the agents' convergence
gate (mitigation) and §III-B's collective schedules on 8 ranks of one
process group over gloo (collectives). Prints each figure's table plus a
final ``name,us_per_call,derived`` CSV summary line per point.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

PORTED = ("fig1", "fig3", "fig4", "fig5", "fig6", "fig7_fig8", "scenarios",
          "faults", "fleet_replay", "mitigation", "collectives")


def _summary(name: str, rows) -> list:
    lines = []
    for r in rows:
        us = (r.get("t_congested_us") or r.get("t_network_us") or "")
        derived = (r.get("ratio") or r.get("cv")
                   or r.get("compute_fraction")
                   or r.get("gbps_congested") or "")
        key = ":".join(str(r.get(k, "")) for k in
                       ("system", "mode", "aggressor", "n_nodes",
                        "vector_bytes", "size", "burst_ms", "pause_ms")
                       if r.get(k))
        lines.append(f"{name}[{key}],{us},{derived}")
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true",
                   help="reduced grids (smoke)")
    p.add_argument("--force", action="store_true",
                   help="ignore the sweep cache")
    p.add_argument("--only", default=",".join(PORTED),
                   help="comma-separated subset, e.g. fig4,fig5")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--cache-dir", default=None,
                   help="CSV cache directory (default: "
                        "artifacts/bench_cache_torch/<device type>)")
    args = p.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    unknown = [s for s in only if s not in PORTED]
    if unknown:
        p.error(f"unknown benchmark(s) {unknown}; ported: {PORTED}")

    from benchmarks import (pt_collective_bench, pt_fault_scenarios,
                            pt_fig1_breakdown, pt_fig3_sawtooth,
                            pt_fig4_nslb, pt_fig5_steady, pt_fig6_bursty,
                            pt_fig7_fig8_scale, pt_fleet_replay,
                            pt_mitigation_lab, pt_new_scenarios)
    from repro_torch.core.fabric.simulator import resolve_device

    device = resolve_device(args.device)
    drivers = {"fig1": pt_fig1_breakdown, "fig3": pt_fig3_sawtooth,
               "fig4": pt_fig4_nslb, "fig5": pt_fig5_steady,
               "fig6": pt_fig6_bursty, "fig7_fig8": pt_fig7_fig8_scale,
               "scenarios": pt_new_scenarios, "faults": pt_fault_scenarios,
               "fleet_replay": pt_fleet_replay,
               "mitigation": pt_mitigation_lab,
               "collectives": pt_collective_bench}
    summary, failed = [], []
    for name in PORTED:
        if name not in only:
            continue
        print(f"\n{'=' * 72}\n== {name}\n{'=' * 72}", flush=True)
        t0 = time.time()
        try:
            rows = drivers[name].main(force=args.force, quick=args.quick,
                                      device=device,
                                      cache_dir=args.cache_dir) or []
        except Exception:  # report every figure, then fail the run
            traceback.print_exc()
            failed.append(name)
            continue
        print(f"[{name}] {len(rows)} points in {time.time() - t0:.0f}s",
              flush=True)
        summary.extend(_summary(name, rows))

    print("\n# name,us_per_call,derived")
    for line in summary:
        print(line)
    if failed:
        print(f"\n[pt_run] FAILED benches: {failed}", file=sys.stderr)
        return 1
    print(f"\n[pt_run] all benches complete ({len(summary)} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
