"""The beyond-paper congestion families on the port: ramp onsets, random
telegraph aggressors, multi-tenant envelope mixes, phased vs flattened
collective schedules, concurrent multi-job interference, and the
cross-scale and cross-topology sweeps (registry: ramp_onset,
random_telegraph, multi_tenant, phased_collectives, multi_job_mix,
scale_sweep, mixed_topology), as ``benchmarks/new_scenarios.py`` runs them
on the JAX package.

Every grid is one batched run (``scenarios.run_grid_spec``; the scale
families through ``bench.run_scale_grid``), one launch of kernel 1 a
step. Prints each family's rows, its wall time, engine steps and kernel-1
launches, its agreement with the JAX package's rows of the same grids
(``pt_common.jax_agreement``), the ramp check and the phased-vs-flat
ratio deltas.

Each registry entry runs as it is. ``scale_sweep``'s full alltoall
ladder pads all 24 of its cells, 16 to 512 nodes, into one bucket of
65,536 flows (a 512-node alltoall cell's), which kernel 1 runs on a
cluster of eight blocks of four 2,048-flow parts.

``PYTHONPATH=src python -m benchmarks.pt_new_scenarios [--quick]
[--force] [--family ramp_onset,...] [--device cpu] [--cache-dir DIR]``
"""
from __future__ import annotations

import argparse
import time

from benchmarks.pt_common import (default_cache_dir, jax_agreement,
                                  scenario_rows, size_label)
from repro_torch.core import scenarios
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.kernels import fabric_step

FAMILIES = ("ramp_onset", "random_telegraph", "multi_tenant",
            "phased_collectives", "multi_job_mix", "scale_sweep",
            "mixed_topology")


def print_rows(name: str, description: str, rows) -> None:
    print(f"\n# {name} — {description}")
    print(f"{'system':>12} {'n':>4} {'victim':>22} {'aggr':>20} "
          f"{'size':>8} {'profile':>22} {'ratio':>7}")
    for r in rows:
        print(f"{r['system']:>12} {r['n_nodes']:>4} "
              f"{r.get('victim', ''):>22} {r['aggressor']:>20} "
              f"{size_label(r['vector_bytes']):>8} "
              f"{r['profile']:>22} {float(r['ratio']):>7.3f}"
              + (f"  [{r['job_times']}]"
                 if name == "multi_job_mix" and r.get("job_times") else ""))


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None, families=FAMILIES):
    device = resolve_device(device)
    cache_dir = cache_dir or default_cache_dir(device)
    all_rows = []
    for name in families:
        scen = scenarios.get(name, quick)
        steps0, launches0 = sim.step_count, fabric_step.launches
        t0 = time.time()
        rows = scenario_rows(scen, device=device, cache_dir=cache_dir,
                             force=force)
        wall = time.time() - t0
        all_rows.extend(rows)
        print_rows(name, scen.description, rows)
        steps = sim.step_count - steps0
        print(f"# {name}: {len(rows)} rows in {wall:.1f}s, {steps} engine "
              f"steps, {fabric_step.launches - launches0} kernel-1 launches"
              + (" (all rows cached)" if steps == 0 else ""), flush=True)
        print(f"# {jax_agreement(name, rows, quick)}", flush=True)
    ramp = [r for r in all_rows if r["profile"].startswith("ramp")]
    if ramp:
        worst = min(float(r["ratio"]) for r in ramp)
        print(f"\n# ramp check: slowest-onset ratio floor {worst:.2f} "
              "(ramps bound steady-state impact from above)")
    phased = [r for r in all_rows if r.get("victim", "").endswith("+phased")]
    if phased:
        flat = {(r["system"], r["victim"], r["aggressor"],
                 r["vector_bytes"], r["profile"]): float(r["ratio"])
                for r in all_rows if "+phased" not in r.get("victim", "")}
        deltas = [float(r["ratio"]) - flat[k] for r in phased
                  if (k := (r["system"], r["victim"][:-len("+phased")],
                            r["aggressor"], r["vector_bytes"],
                            r["profile"])) in flat]
        if deltas:
            print(f"# phased check: phased-vs-flat ratio delta "
                  f"min {min(deltas):+.2f} max {max(deltas):+.2f} over "
                  f"{len(deltas)} paired cells (temporal structure matters)")
    return all_rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--family", default="",
                   help="comma-separated subset of scenario families")
    p.add_argument("--device", default=None)
    p.add_argument("--cache-dir", default=None)
    a = p.parse_args()
    fams = tuple(f for f in a.family.split(",") if f) or FAMILIES
    main(force=a.force, quick=a.quick, device=a.device,
         cache_dir=a.cache_dir, families=fams)
