"""Reference rows for the PyTorch port, computed by the JAX package.

``PYTHONPATH=src python -m benchmarks.pt_jax_reference [--out PATH]
[--only fabric|fig7_fig8|scenarios|scale512|fleet_replay|mitigation|whatif|sweep|encdec|lm|train|moe|dense|dryrun]``

``--only`` takes a comma list of parts.

Runs what ``chip_smoke.py`` drives through ``repro_torch`` on the JAX
package as it stands. ``fabric`` (the default part of the run) writes
``artifacts/bench_cache_torch/jax_reference.json`` with the jax version and
the git commit:

* fig4_nslb quick points and four fig5_steady quick grids: per row the
  ratio, both iteration times, the completed iteration counts and dt;
* fig1_breakdown, the three registry sizes: the simulated network time,
  its iteration counts and the wire bytes;
* fig3_sawtooth, the six registry points: goodput, CV, the length and a
  sha256 of the cut goodput trace;
* fig6_bursty quick, all six grids, and the full burst x pause grid of
  leonardo/64/incast at 2 MiB: per cell the ratio, both times and the
  iteration counts;
* fig7_fig8 (also alone, ``--only fig7_fig8``, which rewrites these keys
  of the file and keeps the others): the fig7_fig8_scale quick grid and a
  reduced alltoall scale grid (CRESCO8 at 128 nodes and LUMI at 256, 2 MiB,
  2 ms bursts with 0.2 ms pauses, 8 iterations), per cell as fig6; and an
  attempt at each full fig7_fig8_scale grid, each in a child process given
  ``FULL_GRID_S`` seconds: its rows, or that it did not finish.

``scenarios`` (``--only scenarios``, which adds these keys to the file
and keeps the others as they are) runs the nine beyond-paper families
(``SCENARIO_FAMILIES``): ``scenarios_quick`` holds the rows of every
quick grid, each with its grid's index; ``scenarios_full`` holds, per
family and full grid, its rows or that it did not finish: each full grid
runs in a child process given ``FULL_GRID_S`` seconds and at most
``CHILD_RSS_GIB`` GiB of resident memory, ``SCENARIO_WORKERS`` at a time.
Per row: the ratio, both times, the iteration counts, ``job_times`` and
``dnf``.

It calls the benchmarks' row functions directly and never
``cached_sweep``, so the committed CSVs under ``artifacts/bench_cache/``
are left as they are.

``scale512`` (``--only scale512``, which adds these keys and keeps the
others) runs the reference's ``bench.run_scale_grid`` over the four
512-node alltoall cells of ``scale_sweep``'s full ladder
(``SCALE512``: victim ring_allgather, 32 KiB, steady, 4 iterations, 1
warm-up), each cell in a child process of its own, all four at once,
given ``FULL_GRID_S`` seconds: ``scale512`` holds their rows, in the
order of ``SCALE512``'s cells, ``scale512_commit`` the commit.

``fleet_replay`` (``--only fleet_replay``, which adds these keys and
keeps the others) runs ``benchmarks/fleet_replay.py``'s quick templates
(the registry's quick points, cresco8/16 and lumi/16):
``fleet_replay_lowering`` holds each template's lowering of seeds 0-7
(per-flow ``kind``, ``bytes_per_iter``, ``flow_start``, ``fct_mask``);
``fleet_replay_quick`` the summaries of the quick replay of 8 seeds
(chunk 512) and each cell's ``it``, ``t`` and histogram totals;
``fleet_replay_full`` the full point (256 seeds on cresco8/32 and
lumi/32, chunk 2048), run in a child process given ``FULL_GRID_S``
seconds: its summaries, or that it did not finish.

``mitigation`` (``--only mitigation``, likewise) runs
``benchmarks/mitigation_lab.py``'s quick candidate space on the quick
``mitigation_panel`` (``mitigation_quick``: each candidate's scores and
per-cell ratios, the frontier, the winner and the two sawtooth CVs);
``benchmarks/fault_scenarios.py``'s fault panel at its quick and full
budgets (``fault_panel``: the panel's cells and the per-fabric winners);
``benchmarks/whatif_bench.py``'s quick agents' race (``agents_quick``:
the grid target and each agent's evaluations to it); and the full lab
(``mitigation_full``) in a child process given ``FULL_GRID_S`` seconds.

``whatif`` (``--only whatif``, likewise) runs
``benchmarks/whatif_bench.py``'s coalescing demo (three mixed-bucket
queries, coalesced in one server and then one server each) at its quick
and full settings (``whatif_quick``, ``whatif_full``): each query's score
table, winner, frontier, finish reason and evaluations, the coalesced
server's stats and the serial servers' calls. No server gets a
``cache_dir``.

``sweep`` (``--only sweep``, likewise) runs the sweep launcher's measured
workload (``repro.launch.sweep._workload``, at the port's engine chunk:
512 steps for the tiny one) once, unsharded, in this process:
``sweep_tiny`` and ``sweep_quick`` hold the scale grid's and the panel's
rows. It sets no ``XLA_FLAGS`` and no compile cache.

``encdec`` (``--only encdec``, likewise) adds ``encdec``: whisper-tiny at
full width and depth (4 + 4 layers), float32 (``benchmarks.pt_serve.
ENCDEC_REFERENCE``), the parameters of ``numpy_params``; two 32-token
prompts over 1,500 frames drawn from a numpy seed
(``pt_serve.reference_frames``); the prefill's last logits and one decode
step's, kept as ``lm`` keeps them, and the loss with the prompts as
labels.

``lm`` writes ``artifacts/bench_cache_torch/jax_lm_reference.json``:
hymba-1.5b at full width, 2 layers, float32 (``benchmarks.pt_serve.
LM_REFERENCE``), with the parameters of
``repro_torch.models.layers.numpy_params``; a prefill of two 1280-token
prompts (crossing the 1024-token window), then 8 decode steps fed JAX's
own greedy tokens. Per step and row it keeps the greedy token, its top-2
margin, the top-16 ids and logits, the logsumexp and the logits at 64
fixed vocabulary indices, never whole logit rows.

``train`` writes ``artifacts/bench_cache_torch/jax_train_reference.json``:
hymba-1.5b at full width, 2 layers, float32 (``benchmarks.pt_train.
TRAIN_REFERENCE``), the same parameters, ``make_train_step`` with
``adamw`` and the stored ``OptConfig`` for 3 steps on ``SyntheticLM``
batches of 2 x 1280 tokens. Per step it keeps the loss and the global
gradient norm; for step 0 each leaf's gradient norm and the gradient at a
few probed elements per leaf; after the last step the parameters at the
same elements. Leaves carry the port's names (``layers.<i>.*``). Without
``--only`` these three parts run.

``moe`` (only with ``--only moe``) writes
``artifacts/bench_cache_torch/jax_moe_reference.json``: grok-1 at full
width, 1 layer, float32 (``benchmarks.pt_serve.MOE_REFERENCE``: 6.53 B
parameters, 26.1 GB), its parameters built leaf by leaf from
``numpy_param_leaves``; a prefill of two 64-token prompts and 4 decode
steps fed JAX's greedy tokens (the prefill's cache padded for them), kept
as ``lm`` keeps them. It needs about 30 GB of host memory.

``dense`` (only with ``--only dense``) writes
``artifacts/bench_cache_torch/jax_dense_reference.json``: phi3-mini at
full width, 2 layers, float32 (``benchmarks.pt_serve.DENSE_REFERENCE``:
0.42 B parameters, 1.7 GB; head size 96), the prompts and steps of ``lm``,
the prefill's cache padded for the decode steps as ``moe`` pads it.

``dryrun`` (only with ``--only dryrun``) writes
``artifacts/bench_cache_torch/jax_dryrun_reference.json``: the reference's
``python -m repro.launch.dryrun --smoke`` (reduced config, seq <= 512,
batch <= 8, its host mesh) in a child process per cell, with
``REPRO_DRYRUN_DIR`` a temporary directory (the dry run sets 512 host
devices at import, so it never runs in this process), for ``DRYRUN_CELLS``:
each cell's ``hlo``, ``memory``, ``roofline`` and ``model_flops``, or, for
a cell the reference could not run, its exit code and last error line.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import time

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "bench_cache_torch", "jax_reference.json")

# fig5_steady quick grids the port is held to: (system, n_nodes, aggressor)
FIG5_GRIDS = (("leonardo", 64, "incast"), ("leonardo", 256, "incast"),
              ("lumi", 256, "incast"), ("cresco8", 256, "incast"))
# the fig6 grid whose full burst x pause table the port is held to, and
# its vector size: long enough that the runs cross burst/pause edges
FIG6_BURST_PAUSE = ("leonardo", 64, "incast", 2 << 20)
# the reduced alltoall scale grid: cells, sizes, (burst, pause) seconds,
# n_iters and warmup
FIG8_ALLTOALL = ((("cresco8", 128), ("lumi", 256)), (2 << 20,),
                 ((2e-3, 0.2e-3),), 8, 2)
# seconds a full fig7_fig8_scale grid may take on the JAX CPU path
FULL_GRID_S = 600
# the beyond-paper families (benchmarks/new_scenarios.py and the fault
# families of benchmarks/fault_scenarios.py), the resident memory a
# child running one full grid may reach before it is stopped, and how
# many such children run at once
SCENARIO_FAMILIES = ("ramp_onset", "random_telegraph", "multi_tenant",
                     "phased_collectives", "multi_job_mix", "scale_sweep",
                     "mixed_topology", "link_fault", "intra_node")
CHILD_RSS_GIB = 8
SCENARIO_WORKERS = 2
# scale_sweep's 512-node alltoall cells: cells, sizes, n_iters and warmup
# (the steady profile)
SCALE512 = ((("haicgu_ib", 512), ("leonardo", 512), ("cresco8", 512),
             ("lumi", 512)), (32 << 10,), 4, 1)
LM_OUT = os.path.join(os.path.dirname(OUT), "jax_lm_reference.json")
MOE_OUT = os.path.join(os.path.dirname(OUT), "jax_moe_reference.json")
DENSE_OUT = os.path.join(os.path.dirname(OUT), "jax_dense_reference.json")
TRAIN_OUT = os.path.join(os.path.dirname(OUT), "jax_train_reference.json")
DRYRUN_OUT = os.path.join(os.path.dirname(OUT), "jax_dryrun_reference.json")
# the reference's smoke dry-run cells the port's are held to: its own
# fixture cell (tests/test_hlo_stats.py), a prefill, a decode and an MoE
DRYRUN_CELLS = (("yi-6b", "train_4k"), ("phi3-mini-3.8b", "prefill_32k"),
                ("yi-6b", "decode_32k"), ("grok-1-314b", "prefill_32k"))


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], check=True,
                              capture_output=True, text=True,
                              cwd=os.path.dirname(__file__)).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _row(r, dt: float, seconds: float) -> dict:
    return {"system": r.system, "n_nodes": r.n_nodes, "victim": r.victim,
            "aggressor": r.aggressor, "profile": r.profile,
            "vector_bytes": r.vector_bytes, "ratio": r.ratio,
            "t_uncongested_s": r.t_uncongested_s,
            "t_congested_s": r.t_congested_s,
            "n_iters": list(r.n_iters), "dt": dt,
            "wall_s": seconds}


def fig4_rows() -> list:
    from benchmarks import fig4_nslb
    from repro.core import bench, congestion as cong, scenarios
    from repro.core.fabric import systems

    rows = []
    for mode, v in scenarios.get("fig4_nslb", True).points:
        sysp = systems.get_system("nanjing_nslb" if mode == "nslb"
                                  else "nanjing_ecmp")
        t0 = time.time()
        # the same call benchmarks.fig4_nslb.run_point makes, kept whole
        # so the row carries times and iteration counts beside the ratio
        r = bench.run_point(sysp, 8, "alltoall", "alltoall", float(v),
                            cong.steady(), n_iters=25, warmup=5)
        seconds = time.time() - t0
        fig4 = fig4_nslb.run_point(mode, float(v))
        if fig4["ratio"] != r.ratio:
            raise SystemExit(f"fig4 {mode} {v}: fig4_nslb ratio "
                             f"{fig4['ratio']} != run_point ratio {r.ratio}")
        case = bench.build_case(sysp, 8, "alltoall", "alltoall")
        dt = bench.choose_dt(case.topo, case.n_victims, float(v), case.lat(),
                             n_phases=case.max_phases)
        rows.append({"mode": mode, **_row(r, dt, seconds)})
        print(f"fig4 {mode} {v}: ratio {r.ratio} n_iters {r.n_iters} "
              f"({seconds:.1f}s)", flush=True)
    return rows


def fig5_rows() -> list:
    from repro.core import bench, scenarios

    scen = scenarios.get("fig5_steady", True)
    rows = []
    for system, n, aggr in FIG5_GRIDS:
        grid = next(g for g in scen.grids if (g.system, g.n_nodes,
                                              g.aggressor) == (system, n,
                                                               aggr))
        t0 = time.time()
        results = scenarios.run_grid_spec(scen, grid)
        seconds = time.time() - t0
        case = bench.build_case(bench.get_system(system), n, grid.victim,
                                aggr)
        for r in results:
            dt = bench.choose_dt(case.topo, case.n_victims, r.vector_bytes,
                                 case.lat(), n_phases=case.max_phases)
            rows.append(_row(r, dt, seconds))
            print(f"fig5 {system}/{n}/{aggr} {r.vector_bytes}: ratio "
                  f"{r.ratio} n_iters {r.n_iters} dt {dt} ({seconds:.1f}s)",
                  flush=True)
    return rows


def fig1_rows() -> list:
    from benchmarks import fig1_breakdown
    from repro.core import bench, congestion as cong, scenarios
    from repro.core.collectives import wire_bytes_model
    from repro.core.fabric import systems

    rows = []
    for (v,) in scenarios.get("fig1_breakdown", False).points:
        t0 = time.time()
        # the network half of benchmarks.fig1_breakdown.run_size
        r = bench.run_point(systems.get_system("haicgu_ib"),
                            fig1_breakdown.N_NODES, "ring_allreduce", "",
                            v, cong.no_congestion(), n_iters=15, warmup=3)
        rows.append({
            "vector_bytes": float(v), "t_uncongested_s": r.t_uncongested_s,
            "n_iters": list(r.n_iters),
            "wire_bytes": wire_bytes_model(
                "ring_all_reduce", fig1_breakdown.N_NODES, v)["bytes"],
            "wall_s": time.time() - t0})
        print(f"fig1 {v}: t_network {r.t_uncongested_s * 1e6:.1f} us "
              f"n_iters {r.n_iters}", flush=True)
    return rows


def fig3_rows() -> list:
    from repro.core import bench, scenarios
    from repro.core.fabric import systems

    rows = []
    for system, v in scenarios.get("fig3_sawtooth", False).points:
        t0 = time.time()
        # benchmarks.fig3_sawtooth.run_point, kept whole for the trace
        res = bench.goodput_trace(systems.get_system(system), 4,
                                  "ring_allgather", v, n_iters=25)
        tr = np.asarray(res.victim_rate_trace, np.float32)
        tr = tr[len(tr) // 3:]
        tr = tr[tr > 0]
        rows.append({
            "system": system, "vector_bytes": float(v),
            "goodput_gbps": float(tr.mean() * 8 / 1e9),
            "cv": float(tr.std() / tr.mean()), "trace_len": int(len(tr)),
            "trace_sha256": hashlib.sha256(tr.tobytes()).hexdigest(),
            "n_iters": int(res.n_done), "wall_s": time.time() - t0})
        print(f"fig3 {system} {v}: {rows[-1]['goodput_gbps']:.2f} Gb/s "
              f"cv {rows[-1]['cv']:.4g} len {len(tr)}", flush=True)
    return rows


def _grid_rows(scen, grid) -> list:
    from repro.core import bench, scenarios

    t0 = time.time()
    results = scenarios.run_grid_spec(scen, grid)
    seconds = time.time() - t0
    case = bench.build_case(bench.get_system(grid.system), grid.n_nodes,
                            grid.victim, grid.aggressor)
    rows = []
    for r in results:
        shown = scenarios.result_row(grid, r)
        prof = next(p for p in grid.profiles if p.label() == r.profile)
        dt = bench.choose_dt(case.topo, case.n_victims, r.vector_bytes,
                             case.lat(), n_phases=case.max_phases)
        rows.append({**_row(r, dt, seconds),
                     "burst_ms": shown["burst_ms"],
                     "pause_ms": shown["pause_ms"],
                     "burst_s": prof.burst_s, "pause_s": prof.pause_s})
    print(f"fig6 {grid.system}/{grid.n_nodes}/{grid.aggressor} "
          f"{grid.sizes}: {[round(r.ratio, 4) for r in results]} "
          f"({seconds:.1f}s)", flush=True)
    return rows


def fig6_rows() -> list:
    from repro.core import scenarios

    scen = scenarios.get("fig6_bursty", True)
    return [row for grid in scen.grids for row in _grid_rows(scen, grid)]


def fig6_burst_pause_rows() -> list:
    from repro.core import scenarios

    system, n, aggr, v = FIG6_BURST_PAUSE
    scen = scenarios.get("fig6_bursty", False)
    grid = next(g for g in scen.grids
                if (g.system, g.n_nodes, g.aggressor) == (system, n, aggr))
    return _grid_rows(scen, dataclasses.replace(grid, sizes=(v,)))


def _scale_rows(label, cells, aggressor, sizes, profiles, n_iters,
                warmup) -> list:
    """A run_scale_grid's rows on the JAX package, each with its cell's
    dt (the bench's choose_dt of that cell)."""
    from repro.core import bench

    t0 = time.time()
    results = bench.run_scale_grid(list(cells), "ring_allgather", aggressor,
                                   sizes, profiles, n_iters=n_iters,
                                   warmup=warmup)
    seconds = time.time() - t0
    cases = {(s, n): bench.build_case(bench.get_system(s), n,
                                      "ring_allgather", aggressor)
             for s, n in cells}
    rows = []
    for r in results:
        case = cases[(r.system, r.n_nodes)]
        prof = next(p for p in profiles if p.label() == r.profile)
        dt = bench.choose_dt(case.topo, case.n_victims, r.vector_bytes,
                             case.lat(), n_phases=case.max_phases)
        rows.append({**_row(r, dt, seconds),
                     "burst_ms": round(prof.burst_s * 1e3, 4),
                     "pause_ms": round(prof.pause_s * 1e3, 4),
                     "burst_s": prof.burst_s, "pause_s": prof.pause_s})
    print(f"{label} {aggressor} {list(cells)}: "
          f"{[round(r.ratio, 4) for r in results]} ({seconds:.1f}s)",
          flush=True)
    return rows


def _scenario_grid_rows(label, quick, index) -> list:
    from repro.core import scenarios

    scen = scenarios.get("fig7_fig8_scale", quick)
    g = scen.grids[index]
    return _scale_rows(label, g.cells, g.aggressor, g.sizes, g.profiles,
                       scen.n_iters, scen.warmup)


def _full_grid(index: int, path: str) -> None:
    """A child process: one full fig7_fig8_scale grid's rows to ``path``."""
    rows = _scenario_grid_rows("fig7_fig8 full", False, index)
    with open(path, "w") as f:
        json.dump(rows, f)


def fig7_fig8_rows() -> dict:
    import multiprocessing
    import tempfile

    from repro.core import congestion as cong, scenarios

    cells, sizes, profiles, n_iters, warmup = FIG8_ALLTOALL
    doc = {"fig7_fig8_quick": _scenario_grid_rows("fig7_fig8 quick", True,
                                                  0),
           "fig7_fig8_alltoall": _scale_rows(
               "fig7_fig8 reduced", cells, "alltoall", sizes,
               tuple(cong.bursty(b, p) for b, p in profiles), n_iters,
               warmup),
           "fig7_fig8_full": []}
    ctx = multiprocessing.get_context("spawn")
    for i, g in enumerate(scenarios.get("fig7_fig8_scale", False).grids):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "rows.json")
            t0 = time.time()
            proc = ctx.Process(target=_full_grid, args=(i, path))
            proc.start()
            proc.join(FULL_GRID_S)
            if proc.is_alive():
                proc.kill()
                proc.join()
            seconds = time.time() - t0
            entry = {"aggressor": g.aggressor,
                     "cells": [list(c) for c in g.cells],
                     "limit_s": FULL_GRID_S, "wall_s": seconds}
            if os.path.exists(path):
                with open(path) as f:
                    entry["rows"] = json.load(f)
            else:
                entry["rows"] = None
                entry["not_finished"] = (
                    f"the JAX CPU path did not finish in {FULL_GRID_S} s "
                    f"(exit code {proc.exitcode})")
                print(f"fig7_fig8 full {g.aggressor}: "
                      f"{entry['not_finished']}", flush=True)
            doc["fig7_fig8_full"].append(entry)
    return doc


def _family_grid_rows(name: str, quick: bool, index: int) -> list:
    """One registry grid of a family on the JAX package, as rows."""
    from repro.core import scenarios

    scen = scenarios.get(name, quick)
    t0 = time.time()
    results = scenarios.run_grid_spec(scen, scen.grids[index])
    seconds = time.time() - t0
    rows = [{"grid": index, "system": r.system, "n_nodes": r.n_nodes,
             "victim": r.victim, "aggressor": r.aggressor,
             "profile": r.profile, "vector_bytes": r.vector_bytes,
             "ratio": r.ratio, "t_uncongested_s": r.t_uncongested_s,
             "t_congested_s": r.t_congested_s, "n_iters": list(r.n_iters),
             "job_times": [list(j) for j in r.job_times], "dnf": r.dnf,
             "wall_s": seconds} for r in results]
    print(f"{name} {'quick' if quick else 'full'} grid {index}: "
          f"{[round(r.ratio, 4) for r in results]} ({seconds:.1f}s)",
          flush=True)
    return rows


def _family_grid_child(name: str, index: int, path: str) -> None:
    """A child process: one full grid's rows to ``path``."""
    rows = _family_grid_rows(name, False, index)
    with open(path, "w") as f:
        json.dump(rows, f)


def _scale512_child(cell, path: str) -> None:
    """A child process: one 512-node alltoall cell's rows to ``path``."""
    from repro.core import congestion as cong

    _, sizes, n_iters, warmup = SCALE512
    rows = _scale_rows("scale512", [tuple(cell)], "alltoall", sizes,
                       (cong.steady(),), n_iters, warmup)
    with open(path, "w") as f:
        json.dump(rows, f)


def scale512_rows() -> dict:
    """The rows of SCALE512's cells, each cell in a child process of its
    own, all at once, each given ``FULL_GRID_S`` seconds."""
    import multiprocessing
    import tempfile

    cells = SCALE512[0]
    ctx = multiprocessing.get_context("spawn")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"cell{i}.json")
                 for i in range(len(cells))]
        procs = [ctx.Process(target=_scale512_child, args=(c, p))
                 for c, p in zip(cells, paths)]
        t0 = time.time()
        for proc in procs:
            proc.start()
        for cell, path, proc in zip(cells, paths, procs):
            proc.join(max(0.0, t0 + FULL_GRID_S - time.time()))
            if proc.is_alive():
                proc.kill()
                proc.join()
            if not os.path.exists(path):
                raise RuntimeError(
                    f"scale512 {cell}: the JAX CPU path did not finish in "
                    f"{FULL_GRID_S} s (exit code {proc.exitcode})")
            with open(path) as f:
                rows += json.load(f)
    return {"scale512": rows, "scale512_commit": _commit()}


def _rss_gib(pid: int) -> float:
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2 ** 20
    except OSError:
        pass
    return 0.0


def scenario_rows() -> dict:
    """The quick grids of every family in this process; each full grid
    in a child process, ``SCENARIO_WORKERS`` at a time, stopped at
    ``FULL_GRID_S`` seconds or ``CHILD_RSS_GIB`` GiB."""
    import multiprocessing
    import tempfile

    from repro.core import scenarios

    quick = {name: [row for i in range(len(scenarios.get(name,
                                                         True).grids))
                    for row in _family_grid_rows(name, True, i)]
             for name in SCENARIO_FAMILIES}
    todo = [(name, i, g) for name in SCENARIO_FAMILIES
            for i, g in enumerate(scenarios.get(name, False).grids)]
    full = {name: [] for name in SCENARIO_FAMILIES}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        running = []
        while todo or running:
            while todo and len(running) < SCENARIO_WORKERS:
                name, i, g = todo.pop(0)
                path = os.path.join(tmp, f"{name}_{i}.json")
                proc = ctx.Process(target=_family_grid_child,
                                   args=(name, i, path))
                proc.start()
                running.append((name, i, g, path, proc, time.time(), 0.0))
            time.sleep(1.0)
            still = []
            for name, i, g, path, proc, t0, peak in running:
                peak = max(peak, _rss_gib(proc.pid))
                late = time.time() - t0 > FULL_GRID_S
                big = peak > CHILD_RSS_GIB
                if proc.is_alive() and not (late or big):
                    still.append((name, i, g, path, proc, t0, peak))
                    continue
                if proc.is_alive():
                    proc.kill()
                proc.join()
                entry = {"grid": i, "system": g.system,
                         "aggressor": g.aggressor, "victim": g.victim,
                         "phased": g.phased,
                         "cells": [list(c) for c in g.cells],
                         "limit_s": FULL_GRID_S,
                         "wall_s": time.time() - t0,
                         "peak_rss_gib": round(peak, 2)}
                if os.path.exists(path) and not (late or big):
                    with open(path) as f:
                        entry["rows"] = json.load(f)
                else:
                    entry["rows"] = None
                    entry["not_finished"] = (
                        f"the JAX CPU path did not finish in {FULL_GRID_S} s"
                        if late or not big else
                        f"stopped at {peak:.1f} GiB of resident memory "
                        f"(limit {CHILD_RSS_GIB})") \
                        + f" (exit code {proc.exitcode})"
                    print(f"{name} full grid {i}: {entry['not_finished']}",
                          flush=True)
                full[name].append(entry)
            running = still
    for name in full:
        full[name].sort(key=lambda e: e["grid"])
    return {"scenarios_quick": quick, "scenarios_full": full,
            "scenarios_commit": _commit()}


FLEET_LOWERING_SEEDS = 8


def _fleet_templates(quick: bool):
    from benchmarks import fleet_replay
    from repro.core import scenarios, workload as wl

    points = scenarios.get("fleet_replay", quick).points
    return [wl.build_template(s)
            for s in fleet_replay._specs(points, quick)], points


def _fleet_summaries(quick: bool) -> dict:
    import jax

    from repro.core import workload as wl

    templates, points = _fleet_templates(quick)
    n_seeds = int(points[0][2])
    chunk = 512 if quick else 2048
    t0 = time.time()
    out, padded = wl.run_replay(templates, np.arange(n_seeds), chunk=chunk,
                                metrics=True, with_trace=False)
    jax.block_until_ready(out)
    seconds = time.time() - t0
    return {"n_seeds": n_seeds, "chunk": chunk,
            "systems": wl.summarize_replay(out, padded),
            "it": np.asarray(out["it"])[..., 0].tolist(),
            "t": np.asarray(out["t"]).tolist(),
            "h_qd_total": np.asarray(out["h_qd"]).sum(-1).tolist(),
            "h_fct_total": np.asarray(out["h_fct"]).sum(-1).tolist(),
            "wall_s": seconds}


def _child(fn_name: str, path: str) -> None:
    """A child process: ``globals()[fn_name]()`` to ``path`` as JSON."""
    doc = globals()[fn_name]()
    with open(path, "w") as f:
        json.dump(doc, f)


def _in_child(fn_name: str, label: str) -> dict:
    """``fn_name()`` in a child process given ``FULL_GRID_S`` seconds: its
    result, or that it did not finish."""
    import multiprocessing
    import tempfile

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.json")
        t0 = time.time()
        proc = ctx.Process(target=_child, args=(fn_name, path))
        proc.start()
        proc.join(FULL_GRID_S)
        if proc.is_alive():
            proc.kill()
            proc.join()
        entry = {"limit_s": FULL_GRID_S, "wall_s": time.time() - t0}
        if os.path.exists(path):
            with open(path) as f:
                entry["result"] = json.load(f)
        else:
            entry["result"] = None
            entry["not_finished"] = (
                f"the JAX CPU path did not finish in {FULL_GRID_S} s "
                f"(exit code {proc.exitcode})")
            print(f"{label}: {entry['not_finished']}", flush=True)
    return entry


def _fleet_full() -> dict:
    return _fleet_summaries(False)


def fleet_replay_rows() -> dict:
    """The fleet replay's reference rows (module docstring)."""
    from repro.core import workload as wl

    templates, _ = _fleet_templates(True)
    seeds = np.arange(FLEET_LOWERING_SEEDS)
    lowering = []
    for t in templates:
        p = wl.lower_seeds(t, seeds)
        lowering.append({
            "system": t.spec.system, "n_nodes": t.spec.n_nodes,
            "n_flows": t.n_flows, "short_idx": t.short_idx.tolist(),
            **{k: np.asarray(getattr(p, k)).tolist()
               for k in ("kind", "bytes_per_iter", "flow_start",
                         "fct_mask")}})
    quick = _fleet_summaries(True)
    print(f"fleet_replay quick: {quick['wall_s']:.1f}s", flush=True)
    return {"fleet_replay_lowering": {"seeds": seeds.tolist(),
                                      "templates": lowering},
            "fleet_replay_quick": quick,
            "fleet_replay_full": _in_child("_fleet_full",
                                           "fleet_replay full"),
            "fleet_replay_commit": _commit()}


def _score_rows(scores) -> dict:
    return {"ratio_min": {s.candidate: s.ratio_min for s in scores},
            "ratio_mean": {s.candidate: s.ratio_mean for s in scores},
            "aggr_gbps": {s.candidate: s.aggr_gbps for s in scores},
            "jain": {s.candidate: s.jain for s in scores},
            "t_base_worst_rel": {s.candidate: s.t_base_worst_rel
                                 for s in scores},
            "cells": {s.candidate: {r.cell: r.ratio for r in s.cells}
                      for s in scores}}


def _lab(quick: bool) -> dict:
    from benchmarks import mitigation_lab
    from repro.core.mitigation import score

    panel = score.panel_from_scenario(quick=quick)
    t0 = time.time()
    scores = score.score_table(
        panel, mitigation_lab.candidate_space(quick),
        n_iters=10 if quick else 15, warmup=2 if quick else 3,
        max_steps=120_000 if quick else 200_000)
    return {**_score_rows(scores),
            "frontier": [s.candidate
                         for s in score.pareto_frontier(scores)],
            "winner": score.pick_winner(scores).candidate,
            "wall_s": time.time() - t0}


def _lab_full() -> dict:
    return _lab(False)


def mitigation_rows() -> dict:
    """The mitigation lab's reference rows (module docstring)."""
    from benchmarks import fault_scenarios, mitigation_lab, whatif_bench
    from repro.core.mitigation import score, search

    quick = _lab(True)
    v = 64 << 20
    quick["cv_default"] = search.sawtooth_cv(
        "haicgu_ce8850", 4, "ring_allgather", v, search.default_candidate())
    quick["cv_tuned"] = search.sawtooth_cv(
        "haicgu_ce8850", 4, "ring_allgather", v,
        mitigation_lab.AI_ECN_UPGRADE)
    print(f"mitigation quick: {quick['wall_s']:.1f}s, winner "
          f"{quick['winner']}", flush=True)
    cells = [c.name for c in score.panel_from_scenario(
        score.FAULT_PANEL_SCENARIO, quick=True)]
    panel = {}
    for label, q in (("quick", True), ("full", False)):
        t0 = time.time()
        res = fault_scenarios.fault_panel(q)
        panel[label] = {"cells": cells, "winners": res["winners"],
                        "wall_s": time.time() - t0}
    t0 = time.time()
    conv, failures = whatif_bench.run_convergence(True)
    agents = {"target": conv["target"], "budget": conv["budget"],
              "batch": conv["batch"], "knobs": conv["knobs"],
              "evals_to_target": {k: d["evals_to_target"]
                                  for k, d in conv["agents"].items()},
              "failures": failures, "wall_s": time.time() - t0}
    return {"mitigation_quick": quick, "fault_panel": panel,
            "agents_quick": agents,
            "mitigation_full": _in_child("_lab_full", "mitigation full"),
            "mitigation_commit": _commit()}


def _whatif_table(res) -> dict:
    return {s.candidate: [s.ratio_min, s.ratio_mean, s.aggr_gbps, s.jain,
                          s.t_base_worst_rel] for s in res.scores}


def _whatif(quick: bool) -> dict:
    """The coalescing demo of benchmarks/whatif_bench.py on the JAX
    package, with every query's table (module docstring)."""
    from benchmarks import whatif_bench
    from repro.runtime import whatif

    kw = dict(n_iters=5, warmup=2, max_steps=50_000) if quick \
        else dict(n_iters=10, warmup=3)
    queries = whatif_bench._coalescing_queries(quick)
    srv = whatif.WhatIfServer(max_batch=len(queries), **kw)
    uids = [srv.submit(q) for q in queries]
    t0 = time.time()
    stats = srv.run_until_drained()
    wall_coal = time.time() - t0
    coalesced = [srv.result(u) for u in uids]
    serial, serial_calls, serial_lanes = [], 0, 0
    t0 = time.time()
    for q in queries:
        one = whatif.WhatIfServer(max_batch=1, **kw)
        u = one.submit(q)
        one.run_until_drained()
        serial.append(one.result(u))
        serial_calls += one.stats.coalesced_calls
        serial_lanes += one.stats.lanes
    wall_serial = time.time() - t0
    return {
        "engine": kw,
        "queries": [{"system": q.system, "n_nodes": q.n_nodes,
                     "vector_bytes": q.vector_bytes,
                     "candidates": [c.label() for c in q.candidates],
                     "table": _whatif_table(r),
                     "winner": r.winner.candidate,
                     "frontier": [s.candidate for s in r.frontier],
                     "finish_reason": r.finish_reason, "evals": r.evals}
                    for q, r in zip(queries, coalesced)],
        "bit_identical": all(_whatif_table(a) == _whatif_table(b)
                             for a, b in zip(coalesced, serial)),
        "stats": {k: v for k, v in dataclasses.asdict(stats).items()
                  if k != "wall_s"},
        "serial_calls": serial_calls, "serial_lanes": serial_lanes,
        "wall_coalesced_s": wall_coal, "wall_serial_s": wall_serial}


def whatif_rows() -> dict:
    """The what-if service's reference rows (module docstring)."""
    out = {}
    for label, quick in (("whatif_quick", True), ("whatif_full", False)):
        out[label] = _whatif(quick)
        print(f"{label}: {out[label]['wall_coalesced_s']:.1f}s coalesced, "
              f"{out[label]['wall_serial_s']:.1f}s serial", flush=True)
    out["whatif_commit"] = _commit()
    return out


def _sweep_workload(tiny: bool) -> dict:
    """``repro.launch.sweep.run_workload(None, tiny=tiny)`` with the port's
    engine chunk for the workload (``repro_torch.launch.sweep``: the tiny
    one syncs every 512 steps, the quick one at the engines' 2,048)."""
    from repro.core import bench
    from repro.core.mitigation import search as msearch
    from repro.launch import sweep
    from repro_torch.launch.sweep import QUICK_CHUNK, TINY_CHUNK

    grid, panel, candidates = sweep._workload(tiny)
    chunk = TINY_CHUNK if tiny else QUICK_CHUNK
    t0 = time.perf_counter()
    pending = bench.launch_scale_grid(
        grid["cells"], grid["victim_coll"], grid["aggr_coll"],
        grid["sizes"], grid["profiles"], n_iters=grid["n_iters"],
        warmup=grid["warmup"], chunk=chunk)
    runs = msearch.run_candidates(panel, candidates, chunk=chunk)
    scale_rows = sweep._result_rows(pending.results())
    panel_rows = sweep._result_rows(runs)
    return {"results_scale": scale_rows, "runs_panel": panel_rows,
            "digest_scale": sweep._digest(scale_rows),
            "digest_panel": sweep._digest(panel_rows),
            "wall_s": round(time.perf_counter() - t0, 3)}


def sweep_rows() -> dict:
    """The sweep workload's reference rows (module docstring), unsharded
    and in this process."""
    out = {}
    for label, tiny in (("sweep_tiny", True), ("sweep_quick", False)):
        out[label] = _sweep_workload(tiny)
        print(f"{label}: {out[label]['wall_s']:.1f}s", flush=True)
    out["sweep_commit"] = _commit()
    return out


def _lm_steps(model, params, prompts, probe, r, mesh=None,
              pad_cache=False, extra=None) -> list:
    """A prefill of ``prompts`` (with the batch entries ``extra``, an
    encoder-decoder's frames), then ``r["decode_steps"]`` decode steps
    fed JAX's own greedy tokens: per step the rows' logit summaries.
    ``pad_cache`` gives a full-attention cache (k, v: (L, B, S, KH, D))
    room for the decode steps' keys, as the server pads it."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from benchmarks import pt_serve

    t0 = time.time()
    with jax.set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        logits, cache = jax.jit(model.prefill)(
            params, {"tokens": jnp.asarray(prompts), **(extra or {})})
        steps = [pt_serve.logit_summary(np.asarray(logits), probe)]
        if pad_cache:
            room = [(0, 0), (0, 0), (0, r["decode_steps"]), (0, 0), (0, 0)]
            cache = {k: jnp.pad(v, room) if k in ("k", "v") else v
                     for k, v in cache.items()}
        print(f"{r['arch']} prefill {prompts.shape}: "
              f"{time.time() - t0:.1f}s", flush=True)
        decode = jax.jit(model.decode)
        S = prompts.shape[1]
        for t in range(r["decode_steps"]):
            tokens = np.array([[row["token"]] for row in steps[-1]],
                              np.int32)
            logits, cache = decode(params, cache, jnp.asarray(tokens),
                                   jnp.int32(S + t))
            steps.append(pt_serve.logit_summary(np.asarray(logits), probe))
    print(f"{r['arch']} {r['decode_steps']} decode steps: "
          f"{time.time() - t0:.1f}s; greedy "
          f"{[[row['token'] for row in st] for st in steps]}", flush=True)
    return steps


def _lm_doc(part, cfg, r, probe, prompts, steps, t0) -> dict:
    import jax

    return {"source": f"benchmarks/pt_jax_reference.py --only {part}",
            "jax_version": jax.__version__,
            "jax_backend": jax.default_backend(), "commit": _commit(),
            "config": {**r, "name": cfg.name, "d_model": cfg.d_model,
                       "vocab_padded": cfg.vocab_padded,
                       "sliding_window": cfg.sliding_window},
            "probe_ids": [int(i) for i in probe],
            "prompts": prompts.tolist(),
            "steps": steps, "wall_s": time.time() - t0}


def lm_reference(r=None, part: str = "lm", pad_cache: bool = False) -> dict:
    """The LM reference rows (module docstring) of the reference config
    ``r`` (default ``pt_serve.LM_REFERENCE``), on the JAX package;
    ``pad_cache`` grows a full-attention cache for the decode steps."""
    import jax
    import jax.numpy as jnp

    from benchmarks import pt_serve
    from repro.configs import get_config
    from repro.models.api import build_model
    from repro.models.layers import single_device_rules
    from repro_torch.models.layers import numpy_params

    r = r or pt_serve.LM_REFERENCE
    cfg = dataclasses.replace(get_config(r["arch"]), n_layers=r["n_layers"],
                              param_dtype=r["dtype"],
                              compute_dtype=r["dtype"], remat="none")
    tcfg = pt_serve.reference_config(r)
    model = build_model(cfg, single_device_rules(), None)
    params = jax.tree.map(jnp.asarray, numpy_params(tcfg, r["param_seed"]))
    prompts = pt_serve.reference_prompts(tcfg, r)
    probe = pt_serve.probe_ids(tcfg, r)
    t0 = time.time()
    steps = _lm_steps(model, params, prompts, probe, r, pad_cache=pad_cache)
    return _lm_doc(part, cfg, r, probe, prompts, steps, t0)


def moe_reference() -> dict:
    """The MoE reference rows (module docstring), on the JAX package: the
    parameters are built leaf by leaf, each numpy leaf dropped once JAX
    holds it, so the host never holds the model twice."""
    import jax.numpy as jnp

    from benchmarks import pt_serve
    from repro.configs import get_config
    from repro.launch.mesh import compat_make_mesh, rules_for
    from repro.models.api import build_model
    from repro_torch.models.layers import numpy_param_leaves

    r = pt_serve.MOE_REFERENCE
    cfg = dataclasses.replace(get_config(r["arch"]), n_layers=r["n_layers"],
                              param_dtype=r["dtype"],
                              compute_dtype=r["dtype"], remat="none")
    tcfg = pt_serve.reference_config(r)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    model = build_model(cfg, rules_for(cfg, mesh), mesh)
    t0 = time.time()
    params = {}
    for path, x in numpy_param_leaves(tcfg, r["param_seed"]):
        node = params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.array(x)
        del x
    print(f"{r['arch']} parameters: {time.time() - t0:.1f}s", flush=True)
    prompts = pt_serve.reference_prompts(tcfg, r)
    probe = pt_serve.probe_ids(tcfg, r)
    steps = _lm_steps(model, params, prompts, probe, r, mesh,
                      pad_cache=True)
    return _lm_doc("moe", cfg, r, probe, prompts, steps, t0)


def encdec_rows() -> dict:
    """The encoder-decoder's reference rows (module docstring), on the
    JAX package, under ``encdec``."""
    import jax
    import jax.numpy as jnp

    from benchmarks import pt_serve
    from repro.configs import get_config
    from repro.models.api import build_model
    from repro.models.layers import single_device_rules
    from repro_torch.models.layers import numpy_params

    r = pt_serve.ENCDEC_REFERENCE
    cfg = dataclasses.replace(get_config(r["arch"]), n_layers=r["n_layers"],
                              param_dtype=r["dtype"],
                              compute_dtype=r["dtype"], remat="none")
    tcfg = pt_serve.reference_config(r)
    model = build_model(cfg, single_device_rules(), None)
    params = jax.tree.map(jnp.asarray, numpy_params(tcfg, r["param_seed"]))
    prompts = pt_serve.reference_prompts(tcfg, r)
    frames = jnp.asarray(pt_serve.reference_frames(tcfg, r))
    probe = pt_serve.probe_ids(tcfg, r)
    t0 = time.time()
    steps = _lm_steps(model, params, prompts, probe, r, pad_cache=True,
                      extra={"frames": frames})
    loss, _ = jax.jit(model.loss)(params, {
        "frames": frames, "tokens": jnp.asarray(prompts),
        "labels": jnp.asarray(prompts)})
    doc = _lm_doc("encdec", cfg, r, probe, prompts, steps, t0)
    doc["config"].update(enc_layers=cfg.enc_layers,
                         n_frontend_tokens=cfg.n_frontend_tokens)
    doc["loss"] = float(loss)
    print(f"{r['arch']} loss {doc['loss']!r} ({doc['wall_s']:.1f}s)",
          flush=True)
    return {"encdec": doc}


def train_reference() -> dict:
    """The training reference rows (module docstring), on the JAX
    package."""
    import jax
    import jax.numpy as jnp

    from benchmarks import pt_train
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch.steps import make_train_step
    from repro.models.api import build_model
    from repro.models.layers import single_device_rules
    from repro.optim.adamw import OptConfig, adamw
    from repro_torch import convert
    from repro_torch.models.layers import numpy_params

    r = pt_train.TRAIN_REFERENCE
    cfg = dataclasses.replace(get_config(r["arch"]), n_layers=r["n_layers"],
                              param_dtype=r["dtype"],
                              compute_dtype=r["dtype"], remat="none")
    tcfg = pt_train.reference_config()
    model = build_model(cfg, single_device_rules(), None)
    params_np = numpy_params(tcfg, r["param_seed"])
    params = jax.tree.map(jnp.asarray, params_np)
    opt = adamw(OptConfig(**r["opt"]))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=r["seq_len"],
                                  global_batch=r["batch"],
                                  seed=r["data_seed"]))

    def port_leaves(tree):
        return {k: v.numpy() for k, v in convert.lm_params_from_jax(
            jax.tree.map(np.asarray, tree), tcfg).items()}

    shapes = {k: v.shape for k, v in port_leaves(params).items()}
    probes = pt_train.probe_index(shapes)
    t0 = time.time()
    batch0 = jax.tree.map(jnp.asarray, data.batch_at(0))
    (loss0, _), grads0 = jax.jit(jax.value_and_grad(
        model.loss, has_aux=True))(params, batch0)
    grad0 = pt_train.leaf_summary(port_leaves(grads0), probes)
    print(f"train step-0 gradient: loss {float(loss0)} "
          f"({time.time() - t0:.1f}s)", flush=True)
    step = jax.jit(make_train_step(model, opt))
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    steps = []
    for i in range(r["steps"]):
        state, metrics = step(state, jax.tree.map(jnp.asarray,
                                                  data.batch_at(i)))
        steps.append({"loss": float(metrics["loss"]),
                      "total_loss": float(metrics["total_loss"]),
                      "grad_norm": float(metrics["grad_norm"])})
        print(f"train step {i}: {steps[-1]} ({time.time() - t0:.1f}s)",
              flush=True)
    after = pt_train.leaf_summary(port_leaves(state["params"]), probes)
    return {"source": "benchmarks/pt_jax_reference.py --only train",
            "jax_version": jax.__version__,
            "jax_backend": jax.default_backend(), "commit": _commit(),
            "config": {**r, "name": cfg.name, "d_model": cfg.d_model,
                       "vocab_padded": cfg.vocab_padded,
                       "sliding_window": cfg.sliding_window},
            "probe_index": probes, "steps": steps,
            "grad0": grad0, "params_after": after,
            "wall_s": time.time() - t0}


def dryrun_reference() -> dict:
    """The reference's smoke dry-run cells (module docstring), each in a
    child process."""
    import sys
    import tempfile

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    cells, t0 = {}, time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape in DRYRUN_CELLS:
            env = dict(os.environ, REPRO_DRYRUN_DIR=tmp, JAX_PLATFORMS="cpu",
                       PYTHONPATH=src + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            env.pop("XLA_FLAGS", None)
            r = subprocess.run(
                [sys.executable, "-m", "repro.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--mesh", "single", "--smoke"], env=env,
                capture_output=True, text=True, timeout=900)
            key = f"{arch}__{shape}__single__smoke"
            path = os.path.join(tmp, key + ".json")
            if r.returncode != 0 or not os.path.exists(path):
                lines = (r.stderr or "").strip().splitlines()
                errs = [ln for ln in lines if "Error:" in ln] or lines[-1:]
                cells[key] = {"status": "not_run", "returncode": r.returncode,
                              "error": errs[-1][:600] if errs else ""}
                print(f"{key}: the reference could not run it", flush=True)
                continue
            with open(path) as f:
                cell = json.load(f)
            cells[key] = {k: cell[k] for k in (
                "arch", "shape", "mesh", "n_devices", "status", "smoke",
                "hlo", "memory", "roofline", "model_flops") if k in cell}
    import jax
    return {"source": "benchmarks/pt_jax_reference.py --only dryrun",
            "jax_version": jax.__version__, "commit": _commit(),
            "command": "python -m repro.launch.dryrun --arch A --shape S "
                       "--mesh single --smoke",
            "not_run": sorted(k for k, c in cells.items()
                              if c["status"] == "not_run"),
            "cells": cells, "wall_s": time.time() - t0}


def _write(doc: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="output file (default: the part's file under "
                         "artifacts/bench_cache_torch/)")
    ap.add_argument("--only", default=None,
                    help="comma list of fabric, fig7_fig8, scenarios, "
                         "scale512, fleet_replay, mitigation, whatif, sweep, encdec, "
                         "lm, train, moe, dense, dryrun")
    args = ap.parse_args()
    parts = ("fabric", "fig7_fig8", "scenarios", "scale512",
             "fleet_replay", "mitigation", "whatif", "sweep", "encdec", "lm",
             "train", "moe", "dense", "dryrun")
    only = [p for p in (args.only or "").split(",") if p]
    if any(p not in parts for p in only):
        ap.error(f"--only takes a comma list of {parts}")
    run = set(only) or {"fabric", "lm", "train"}
    import jax

    if "fabric" in run:
        doc = {"source": "benchmarks/pt_jax_reference.py",
               "jax_version": jax.__version__,
               "jax_backend": jax.default_backend(),
               "commit": _commit(),
               "fig4_nslb": fig4_rows(),
               "fig5_steady": fig5_rows(),
               "fig1_breakdown": fig1_rows(),
               "fig3_sawtooth": fig3_rows(),
               "fig6_bursty_quick": fig6_rows(),
               "fig6_burst_pause": fig6_burst_pause_rows(),
               **fig7_fig8_rows()}
        _write(doc, args.out or OUT)
    # parts that add their keys to the file and keep the others
    for part, rows in (("fig7_fig8", fig7_fig8_rows),
                       ("scenarios", scenario_rows),
                       ("scale512", scale512_rows),
                       ("fleet_replay", fleet_replay_rows),
                       ("mitigation", mitigation_rows),
                       ("whatif", whatif_rows), ("sweep", sweep_rows),
                       ("encdec", encdec_rows)):
        if part in run:
            path = args.out or OUT
            with open(path) as f:
                doc = json.load(f)
            doc.update(rows())
            if part == "fig7_fig8":
                doc["fig7_fig8_commit"] = _commit()
            _write(doc, path)
    if "lm" in run:
        _write(lm_reference(), (only and args.out) or LM_OUT)
    if "train" in run:
        _write(train_reference(), (only and args.out) or TRAIN_OUT)
    if "moe" in run:
        _write(moe_reference(), (only and args.out) or MOE_OUT)
    if "dense" in run:
        from benchmarks import pt_serve
        _write(lm_reference(pt_serve.DENSE_REFERENCE, "dense",
                            pad_cache=True), (only and args.out) or DENSE_OUT)
    if "dryrun" in run:
        _write(dryrun_reference(), (only and args.out) or DRYRUN_OUT)

if __name__ == "__main__":
    main()
