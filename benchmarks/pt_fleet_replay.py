"""Fleet-scale stochastic workload replay on the port, as
``benchmarks/fleet_replay.py`` runs it on the JAX package.

Replays seeded stochastic workloads (core/workload.py: Poisson short
flows + long-lived training tenants with per-tenant CC mixes) as one
batch of (template, seed) cells through the scale-batched engine, with
the streaming percentile metrics (queue delay and FCT histograms,
per-tenant slowdown) carried in the engine's state; no per-step trace is
kept. One replay is one batch: every engine step is one launch of
kernel 1 for all cells, and this script checks that the launches equal
the steps.

Per seed count it measures, over all systems stacked into one geometry
bucket:

* ``seeds_per_sec`` and ``sim_s_per_wall_s``: how many seeds (and
  simulated fabric-seconds) one wall-second buys;
* ``metrics_overhead``: the wall of the metrics-on run over the
  metrics-off run of the same batch (both without a trace).

Sanity gates (a failure raises): p99 >= p50 on the aggregate queue delay,
short flows complete (FCT samples > 0), per-flow delivered bytes respect
the NIC capacity bound (``CAP_TOL``), and shorts never deliver more than
the seed drew for them. With ``--quick`` the rows are also held to the
JAX package's (``jax_reference.json["fleet_replay_quick"]``, written by
``benchmarks/pt_jax_reference.py --only fleet_replay``).

``PYTHONPATH=src python -m benchmarks.pt_fleet_replay [--quick]
[--seed-counts N,N] [--device cpu] [--cache-dir DIR]``
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.pt_common import (REFERENCE, cached_sweep, default_cache_dir,
                                  device_name)
from repro_torch.core import metrics as met
from repro_torch.core import scenarios as scen
from repro_torch.core import workload as wl
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.kernels import fabric_step

SEED_COUNTS_FULL = (256, 1024)
CAP_TOL = 1.05  # float32 accumulation slack on the capacity bound
# one bin's width: a percentile read from the port's histogram must land
# within this factor of JAX's
BIN_FACTOR = 10.0 ** (1.0 / met.BINS_PER_DECADE)
SLOWDOWN_REL = 1e-3
KEYS = ["system", "n_nodes", "n_seeds"]


def specs(points, quick: bool) -> List[wl.WorkloadSpec]:
    """One WorkloadSpec per registry point (deduped by system/n_nodes),
    as ``benchmarks/fleet_replay.py`` builds them."""
    seen = {}
    for system, n_nodes, _ in points:
        key = (system, int(n_nodes))
        if key in seen:
            continue
        if quick:
            seen[key] = wl.WorkloadSpec(
                system=system, n_nodes=int(n_nodes), short_slots=16,
                arrivals_mean=8.0, horizon_s=4e-3,
                tenant_bytes=float(1 << 19))
        else:
            seen[key] = wl.WorkloadSpec(system=system, n_nodes=int(n_nodes))
    return list(seen.values())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_replay(templates, seeds, *, chunk: int, metrics: bool, device):
    """One replay: (out, padded, wall seconds, engine steps, kernel-1
    launches)."""
    steps0, launches0 = sim.step_count, fabric_step.launches
    _sync(device)
    t0 = time.perf_counter()
    out, padded = wl.run_replay(templates, seeds, chunk=chunk,
                                metrics=metrics, with_trace=False,
                                device=device)
    _sync(device)
    wall = time.perf_counter() - t0
    return (out, padded, wall, sim.step_count - steps0,
            fabric_step.launches - launches0)


def sanity(out, padded, seeds, summaries, device) -> List[str]:
    """``benchmarks/fleet_replay.py``'s distribution and conservation
    gates."""
    fails = []
    for k, (t, s) in enumerate(zip(padded, summaries)):
        tag = f"{t.spec.system}/n{t.spec.n_nodes}"
        qd = s["qdelay_s"]
        if not np.isnan(qd["0.99"]) and qd["0.99"] < qd["0.5"]:
            fails.append(f"{tag}: p99 qdelay {qd['0.99']:.3g} < "
                         f"p50 {qd['0.5']:.3g}")
        if s["fct_samples"] <= 0:
            fails.append(f"{tag}: no short-flow completions")
        # capacity bound: no flow delivers more than its NIC could carry
        fb = np.asarray(out["fbytes"])[k]  # (B, F)
        cap = t.host_caps[None, :] * np.asarray(out["t"])[k][:, None]
        if (fb > cap * CAP_TOL + 1.0).any():
            fails.append(f"{tag}: delivered bytes exceed NIC capacity")
        # shorts conservation: delivered <= drawn + one Euler-step quantum
        drawn = wl.lower_seeds(t, seeds, device).bytes_per_iter.cpu() \
            .numpy()[:, t.short_idx]
        got = fb[:, t.short_idx]
        quantum = t.host_caps[t.short_idx] * t.dt
        if (got > drawn + quantum[None, :] * CAP_TOL + 1.0).any():
            fails.append(f"{tag}: shorts delivered more than drawn")
    return fails


def jax_agreement(summaries: List[Dict], n_seeds: int,
                  reference: str = REFERENCE) -> List[str]:
    """The quick replay against the JAX package's summaries: equal sample
    counts and per-job completions, every percentile within one bin,
    per-job slowdown means within ``SLOWDOWN_REL``. Returns the
    disagreements (an empty list when it holds)."""
    with open(reference) as f:
        want = json.load(f).get("fleet_replay_quick")
    if not want or want["n_seeds"] != n_seeds:
        return [f"no JAX quick replay of {n_seeds} seeds in {reference}"]
    return compare_summaries(summaries, want["systems"])


def compare_summaries(got: List[Dict], want: List[Dict]) -> List[str]:
    bad = []
    for g, w in zip(got, want):
        tag = f"{g['system']}/n{g['n_nodes']}"
        if (g["system"], g["n_nodes"]) != (w["system"], w["n_nodes"]):
            bad.append(f"{tag}: JAX row is {w['system']}/n{w['n_nodes']}")
            continue
        for k in ("qdelay_samples", "fct_samples"):
            if g[k] != w[k]:
                bad.append(f"{tag}: {k} {g[k]} vs JAX {w[k]}")
        for metric in ("qdelay_s", "fct_s"):
            for q, v in w[metric].items():
                x = g[metric][q]
                if np.isnan(v) != np.isnan(x) or (
                        not np.isnan(v)
                        and not v / BIN_FACTOR * 0.999 <= x
                        <= v * BIN_FACTOR * 1.001):
                    bad.append(f"{tag}: {metric} p{q} {x:.4g} vs JAX "
                               f"{v:.4g} (more than one bin)")
        for job, wj in w["jobs"].items():
            gj = g["jobs"].get(job)
            if gj is None or gj["completions"] != wj["completions"]:
                bad.append(f"{tag}: {job} completions "
                           f"{gj and gj['completions']} vs JAX "
                           f"{wj['completions']}")
                continue
            a, b = gj["slowdown_mean"], wj["slowdown_mean"]
            if not (np.isnan(a) and np.isnan(b)) and not \
                    abs(a - b) <= SLOWDOWN_REL * abs(b):
                bad.append(f"{tag}: {job} slowdown mean {a:.6g} vs JAX "
                           f"{b:.6g}")
    return bad


def run_seed_counts(points, seed_counts, quick: bool, chunk: int,
                    device) -> List[Dict]:
    templates = [wl.build_template(s) for s in specs(points, quick)]
    rows = []
    for n_seeds in seed_counts:
        seeds = np.arange(n_seeds, dtype=np.int64)
        out, padded, wall_m, steps, launches = timed_replay(
            templates, seeds, chunk=chunk, metrics=True, device=device)
        plain, _, wall_p, steps_p, _ = timed_replay(
            templates, seeds, chunk=chunk, metrics=False, device=device)
        summaries = wl.summarize_replay(out, padded)
        sim_s = float(np.asarray(out["t"]).sum())
        fails = sanity(out, padded, seeds, summaries, device)
        if launches != (steps if device.type == "cuda" else 0):
            fails.append(f"{n_seeds} seeds: {launches} kernel-1 launches "
                         f"for {steps} engine steps")
        if not np.array_equal(out["fbytes"].view(np.int32),
                              plain["fbytes"].view(np.int32)):
            fails.append(f"{n_seeds} seeds: fbytes differ with the metrics "
                         "on and off")
        if quick:
            fails += jax_agreement(summaries, n_seeds)
        rows.append({
            "n_seeds": n_seeds, "n_systems": len(templates),
            "n_cells": n_seeds * len(templates),
            "flows_per_cell": padded[0].n_flows,
            "wall_s_metrics": wall_m, "wall_s_plain": wall_p,
            "metrics_overhead": wall_m / max(wall_p, 1e-9),
            "seeds_per_sec": n_seeds * len(templates) / wall_m,
            "sim_s_per_wall_s": sim_s / wall_m,
            "steps": steps, "steps_plain": steps_p,
            "kernel1_launches": launches,
            "device": device_name(device),
            "systems": summaries, "failures": fails,
        })
        r = rows[-1]
        print(f"  seeds={n_seeds:5d} cells={r['n_cells']} wall="
              f"{wall_m:.2f}s (plain {wall_p:.2f}s, overhead "
              f"x{r['metrics_overhead']:.3f})  {r['seeds_per_sec']:.1f} "
              f"seeds/s  {r['sim_s_per_wall_s']:.3g} sim-s/s  "
              f"steps={steps} kernel-1 launches={launches}", flush=True)
        for s in summaries:
            print(f"    {s['system']:8s} n={s['n_nodes']:3d} "
                  f"qdelay p50={s['qdelay_s']['0.5']:.3g}s "
                  f"p99={s['qdelay_s']['0.99']:.3g}s  "
                  f"fct p99={s['fct_s']['0.99']:.3g}s "
                  f"({s['fct_samples']:.0f} completions)")
        for f in fails:
            print(f"    SANITY FAIL: {f}")
    return rows


def _csv_rows(scenario, rows, cache_dir: str) -> List[Dict]:
    """Per-system summaries as the registry's CSV rows, keyed by
    (system, n_nodes, n_seeds)."""
    by_sys = {}
    for row in rows:
        for s in row["systems"]:
            by_sys[(s["system"], str(s["n_nodes"]), str(row["n_seeds"]))] = {
                "qdelay_p50_s": s["qdelay_s"]["0.5"],
                "qdelay_p99_s": s["qdelay_s"]["0.99"],
                "fct_p99_s": s["fct_s"]["0.99"],
                "fct_samples": s["fct_samples"],
                "seeds_per_sec": row["seeds_per_sec"],
                "metrics_overhead": row["metrics_overhead"],
                "device": row["device"],
            }
    points = sorted(by_sys, key=lambda k: (int(k[2]), k[0], int(k[1])))
    return cached_sweep("fleet_replay", KEYS, points,
                        lambda *k: by_sys[tuple(k)], cache_dir=cache_dir,
                        force=True)


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None, seed_counts=None, chunk=None) -> List[Dict]:
    device = resolve_device(device)
    cache_dir = cache_dir or default_cache_dir(device)
    scenario = scen.get("fleet_replay", quick)
    if seed_counts is None:
        seed_counts = SEED_COUNTS_FULL if not quick else tuple(
            sorted({int(ns) for _, _, ns in scenario.points}))
    chunk = chunk or (512 if quick else 2048)
    print(f"fleet_replay: points={scenario.points} seed_counts="
          f"{seed_counts} chunk={chunk} device={device_name(device)}")
    t0 = time.time()
    rows = run_seed_counts(scenario.points, seed_counts, quick, chunk, device)
    out = _csv_rows(scenario, rows, cache_dir)
    print(f"\n[pt_fleet_replay] done in {time.time() - t0:.0f}s")
    failures = [f for r in rows for f in r["failures"]]
    if failures:
        raise RuntimeError("fleet replay checks failed: "
                           + "; ".join(failures))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--force", action="store_true")
    p.add_argument("--seed-counts", default=None, metavar="N,N")
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--cache-dir", default=None)
    a = p.parse_args()
    try:
        main(quick=a.quick, force=a.force, device=a.device,
             cache_dir=a.cache_dir, chunk=a.chunk,
             seed_counts=tuple(int(s) for s in a.seed_counts.split(","))
             if a.seed_counts else None)
    except RuntimeError as e:
        print(f"[pt_fleet_replay] {e}", file=sys.stderr)
        sys.exit(1)
