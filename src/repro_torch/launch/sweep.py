"""Sharded experiment sweep launcher of the port.

One batched engine run (``simulator.run_cells_hetero``) takes one device;
this layer splits the batch over a mesh (``launch.mesh.make_sweep_mesh``,
a tuple of devices):

* **per-device dispatch** (default): the cell (or candidate-lane) axis is
  cut into contiguous shards (:func:`_shard_bounds`), each run through
  the same ``run_cells_hetero`` on its own device, and
  :class:`ShardedOut` concatenates one output across shards on first
  access. The port's engine syncs once a chunk, so the shards run one
  after another; ``--host-devices N`` on one card runs N shards on it. A
  cell runs bit for bit as it does in any other batch (fixed-order sums,
  no float atomics), so a sharded run equals the single-device run.
* **shard_map dispatch** (``dispatch='shard_map'``):
  ``run_cells_hetero(mesh=...)``, which pads the batch to a multiple of
  the device count and runs the same per-device split (PyTorch has no
  partitioned compile); bit-identical as well.

The kernel build directory (``kernels._build``) is the twin of the
reference's persistent compile cache: ``--cache-dir`` points a child's
builds there, and ``--smoke`` shows that a relaunch builds nothing.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.sweep --smoke [--tiny]
      [--host-devices 2] [--device cpu]
      # single-device vs sharded children (fresh processes): asserts
      # bit-identity and, on a card, that a warm relaunch builds nothing
  PYTHONPATH=src python -m repro_torch.launch.sweep --child ...
      # one measured workload process (used by --smoke)
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from collections.abc import Mapping

import numpy as np


def _shard_bounds(n: int, n_shards: int):
    """Contiguous balanced split of ``n`` items into at most ``n_shards``
    non-empty (lo, hi) ranges."""
    base, extra = divmod(n, n_shards)
    bounds, lo = [], 0
    for i in range(n_shards):
        width = base + (1 if i < extra else 0)
        if width == 0:
            break
        bounds.append((lo, lo + width))
        lo += width
    return bounds


class ShardedOut(Mapping):
    """Per-shard run outputs seen as one: a key is concatenated across
    shards on first access."""

    def __init__(self, outs, axis: int):
        self._outs = outs
        self._axis = axis
        self._cache = {}

    def __getitem__(self, key):
        if key not in self._cache:
            self._cache[key] = np.concatenate(
                [np.asarray(o[key]) for o in self._outs], axis=self._axis)
        return self._cache[key]

    def __iter__(self):
        return iter(self._outs[0])

    def __len__(self):
        return len(self._outs[0])


def dispatch_hetero(geoms, params, n_iters, *, mesh, shard_axis="cell",
                    chunk=2048, max_chunks=98, stride=8,
                    **engine_kw) -> ShardedOut:
    """Per-device dispatch of a run_cells_hetero batch: cut the requested
    axis into one contiguous shard a device of ``mesh`` and run each on
    its device."""
    from repro_torch.core.fabric import simulator as sim

    if shard_axis not in ("cell", "lane"):
        raise ValueError(f"shard_axis must be 'cell' or 'lane', "
                         f"got {shard_axis!r}")
    axis = 0 if shard_axis == "cell" else 1
    devices = sim.mesh_devices(mesh)
    n = params.dt.shape[axis]
    outs = []
    for (lo, hi), dev in zip(_shard_bounds(n, len(devices)), devices):
        g = geoms if axis == 1 else sim.slice_batch(geoms, lo, hi)
        outs.append(sim.run_cells_hetero(
            g, sim.slice_batch(params, lo, hi, axis), n_iters, chunk=chunk,
            max_chunks=max_chunks, stride=stride, device=dev, **engine_kw))
    return ShardedOut(outs, axis)


def device_launcher(mesh, *, shard_axis: str = "cell",
                    dispatch: str = "devices", donate: bool = False):
    """A launcher with run_cells_hetero's calling convention, bound to
    ``mesh``: what bench.run_scale_grid, search.run_candidates,
    agents.PanelEvaluator and workload.run_replay take as ``launcher=``
    (a ``mesh=`` there builds one)."""
    if dispatch not in ("devices", "shard_map"):
        raise ValueError(f"dispatch must be 'devices' or 'shard_map', "
                         f"got {dispatch!r}")

    def launcher(geoms, params, n_iters, *, chunk=2048, max_chunks=98,
                 stride=8, **engine_kw):
        if dispatch == "shard_map":
            from repro_torch.core.fabric import simulator as sim

            return sim.run_cells_hetero(geoms, params, n_iters,
                                        chunk=chunk, max_chunks=max_chunks,
                                        stride=stride, mesh=mesh,
                                        shard_axis=shard_axis,
                                        donate=donate, **engine_kw)
        return dispatch_hetero(geoms, params, n_iters, mesh=mesh,
                               shard_axis=shard_axis, chunk=chunk,
                               max_chunks=max_chunks, stride=stride,
                               **engine_kw)

    return launcher


def whatif_launcher(mesh, *, dispatch: str = "devices"):
    """Lane-sharded launcher for runtime.whatif.WhatIfServer: a coalesced
    wave stacks queries on the cell axis and candidates on the lane axis,
    so the lanes are split across the mesh; results equal the
    single-device run's bit for bit."""
    return device_launcher(mesh, shard_axis="lane", dispatch=dispatch)


# --------------------------------------------------------------------------
# Measured child workload: quick scale sweep + mitigation panel
# --------------------------------------------------------------------------

TINY_CELLS = (("cresco8", 8), ("cresco8", 12))
# engine steps between host syncs: the tiny cells end well inside 512
# steps, and a cell runs to the end of its chunk, so at the engines'
# 2,048 three quarters of the tiny smoke's steps ran past the cells' end
TINY_CHUNK, QUICK_CHUNK = 512, 2048
QUICK_CELLS = (("cresco8", 16), ("cresco8", 64),
               ("lumi", 16), ("lumi", 64))
MiB = float(2 ** 20)


def _workload(tiny: bool):
    """The measured sweep: the quick ``scale_sweep`` grid (2 scales x 2
    systems, ring AllGather against AlltoAll at 2 MiB) plus the quick
    mitigation panel x 3 candidates. ``tiny`` shrinks both for the
    subprocess test, and syncs the engine every ``TINY_CHUNK`` steps
    (both phases)."""
    from repro_torch.core import congestion as cong
    from repro_torch.core.fabric.routing import POLICY_ECMP, POLICY_NSLB
    from repro_torch.core.mitigation import score as mscore
    from repro_torch.core.mitigation import search as msearch

    cells = TINY_CELLS if tiny else QUICK_CELLS
    sizes = (MiB / 4,) if tiny else (2 * MiB,)
    grid = dict(cells=list(cells), victim_coll="ring_allgather",
                aggr_coll="alltoall", sizes=sizes,
                profiles=(cong.steady(),),
                n_iters=6 if tiny else 15, warmup=2 if tiny else 3,
                chunk=TINY_CHUNK if tiny else QUICK_CHUNK)
    panel = mscore.panel_from_scenario("mitigation_panel", quick=True)
    candidates = [msearch.default_candidate(),
                  msearch.Candidate(policy=POLICY_ECMP),
                  msearch.Candidate(policy=POLICY_NSLB)]
    if tiny:
        panel = panel[:1]
        candidates = candidates[:2]
    return grid, panel, candidates


def _result_rows(objs):
    rows = [dataclasses.asdict(r) for r in objs]
    for row in rows:  # canonical float types for the digest
        for k, v in row.items():
            if isinstance(v, (np.floating, np.integer)):
                row[k] = float(v)
    return rows


def _digest(rows) -> str:
    """Bit-level digest of marshalled results (full-precision float repr,
    sorted keys): equal digests mean bit-identical runs."""
    blob = json.dumps(rows, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()


def run_workload(mesh, *, tiny: bool, dispatch: str = "devices",
                 device=None) -> dict:
    """Run the measured sweep once, the scale grid sharded on its cell
    axis and the panel on its lane axis when ``mesh`` is given (on
    ``device`` when it is not), and return rows + digests."""
    from repro_torch.core import bench
    from repro_torch.core.fabric import simulator as sim
    from repro_torch.core.mitigation import search as msearch
    from repro_torch.kernels import fabric_step as fs

    grid, panel, candidates = _workload(tiny)
    steps0, launches0 = sim.step_count, fs.launches
    t0 = time.perf_counter()
    scale_launcher = panel_launcher = None
    if mesh is not None:
        scale_launcher = device_launcher(mesh, shard_axis="cell",
                                         dispatch=dispatch)
        panel_launcher = device_launcher(mesh, shard_axis="lane",
                                         dispatch=dispatch)
    pending = bench.launch_scale_grid(
        grid["cells"], grid["victim_coll"], grid["aggr_coll"],
        grid["sizes"], grid["profiles"], n_iters=grid["n_iters"],
        warmup=grid["warmup"], chunk=grid["chunk"], launcher=scale_launcher,
        device=device)
    t_launch = time.perf_counter() - t0
    runs = msearch.run_candidates(panel, candidates, chunk=grid["chunk"],
                                  launcher=panel_launcher, device=device)
    scale_results = pending.results()
    wall = time.perf_counter() - t0
    scale_rows = _result_rows(scale_results)
    panel_rows = _result_rows(runs)
    return {
        "n_shards": 1 if mesh is None else len(mesh),
        "device": str(device if mesh is None else mesh[0]),
        "dispatch": "single" if mesh is None else dispatch,
        "launch_s": round(t_launch, 4),
        "wall_s": round(wall, 3),
        "steps": sim.step_count - steps0,
        "kernel1_launches": fs.launches - launches0,
        "digest_scale": _digest(scale_rows),
        "digest_panel": _digest(panel_rows),
        "results_scale": scale_rows,
        "runs_panel": panel_rows,
    }


def _library_count(path) -> int:
    if not path or not os.path.isdir(path):
        return 0
    return sum(1 for f in os.listdir(path) if f.endswith(".so"))


def child_main(args) -> dict:
    """One measured process: the build directory given by ``--cache-dir``
    (default: the repository's), the workload run twice (the rerun's
    digests must equal the first's). Kernel builds are read from
    ``kernels._build.stats``: every library the process uses is built or
    found during the first run, so the first run's counts are the
    process's build bill."""
    from repro_torch.core.fabric import simulator as sim
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_sweep_mesh

    if args.cache_dir:
        _build.use_build_dir(args.cache_dir)
    device = sim.resolve_device(args.device)
    if device.type == "cpu":
        import torch

        # the smoke's CPU children run at once, and at these cells ATen's
        # pool buys no speed: three children with a pool of every core
        # each took the tiny smoke from 44 s to 127 s on an 8-core host
        torch.set_num_threads(1)
    mesh = None if args.single else make_sweep_mesh(args.host_devices,
                                                    device=device)
    before = dict(_build.stats)
    first = run_workload(mesh, tiny=args.tiny, dispatch=args.dispatch,
                         device=device)
    meter = {k: _build.stats[k] - before[k] for k in before}
    second = run_workload(mesh, tiny=args.tiny, dispatch=args.dispatch,
                          device=device)
    out = dict(first)
    out["rerun_identical"] = (
        first["digest_scale"] == second["digest_scale"]
        and first["digest_panel"] == second["digest_panel"])
    out["wall_first_s"] = first["wall_s"]
    out["wall_second_s"] = second["wall_s"]
    out["launch_first_s"] = first["launch_s"]
    out["launch_second_s"] = second["launch_s"]
    out["builds"] = meter["builds"]
    out["build_hits"] = meter["hits"]
    out["build_s"] = round(meter["seconds"], 4)
    out["cache_dir"] = args.cache_dir or ""
    out["cache_entries"] = _library_count(args.cache_dir)
    return out


# --------------------------------------------------------------------------
# Smoke orchestration: single vs sharded-cold vs sharded-warm children
# --------------------------------------------------------------------------


def _spawn_child(*, host_devices, cache_dir, out_path, tiny, dispatch,
                 device, single=False) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.sweep", "--child",
           "--out", out_path, "--dispatch", dispatch,
           "--host-devices", str(host_devices)]
    if single:
        cmd.append("--single")
    if cache_dir:
        cmd += ["--cache-dir", cache_dir]
    if tiny:
        cmd.append("--tiny")
    if device:
        cmd += ["--device", str(device)]
    env = dict(os.environ)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.out_path = out_path
    return proc


def _join_child(proc: subprocess.Popen) -> dict:
    try:
        stdout, stderr = proc.communicate(timeout=1800)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"sweep child failed ({' '.join(proc.args)}):\n"
                           f"{stdout[-2000:]}\n{stderr[-4000:]}")
    with open(proc.out_path) as f:
        return json.load(f)


# why the warm child and the build-cache checks are left out on the CPU
NO_BUILD_ON_CPU = ("on the CPU every kernel call runs its plain version: "
                   "nothing is built, so there is no build cache to check "
                   "and a warm relaunch would repeat the cold one")
CACHE_CHECKS = ("cache_populated", "cache_hit_on_relaunch",
                "cache_cuts_compile")


def run_smoke(host_devices: int = 2, *, tiny: bool = False,
              dispatch: str = "devices", device=None, workdir=None) -> dict:
    """Fresh children run the same workload (1) on one device, (2) in
    ``host_devices`` shards on an empty build directory (cold), (3) the
    same on that directory (warm). Checks that the sharded results equal
    the single run's bit for bit, that each child's rerun equals its
    first run, and that the cold child built kernel 1 and the warm one
    built nothing and spent under 0.6x the cold one's build seconds. On a
    card the children run one after another. On the CPU nothing is
    built: the warm child and the build-cache checks are left out (the
    report says why), and the other two run at once, one ATen thread
    each."""
    from repro_torch.core.fabric import simulator as sim

    device = sim.resolve_device(device)
    if workdir is None:
        with tempfile.TemporaryDirectory(
                prefix="repro_torch_sweep_smoke_") as tmp:
            return run_smoke(host_devices, tiny=tiny, dispatch=dispatch,
                             device=device, workdir=tmp)
    builds = device.type == "cuda"
    cache_dir = os.path.join(workdir, "build")
    kw = dict(tiny=tiny, dispatch=dispatch, device=device)
    specs = [dict(host_devices=1, cache_dir=None, single=True,
                  out_path=os.path.join(workdir, "single.json"), **kw),
             dict(host_devices=host_devices, cache_dir=cache_dir,
                  out_path=os.path.join(workdir, "cold.json"), **kw)]
    if builds:
        specs.append(dict(host_devices=host_devices, cache_dir=cache_dir,
                          out_path=os.path.join(workdir, "warm.json"), **kw))
        children = [_join_child(_spawn_child(**sp)) for sp in specs]
    else:
        procs = [_spawn_child(**sp) for sp in specs]
        try:
            children = [_join_child(p) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    single, sharded = children[0], children[1:]
    checks = {
        "sharded": all(c["n_shards"] == max(2, host_devices)
                       for c in sharded),
        "bit_identical_scale": all(c["digest_scale"] == single["digest_scale"]
                                   for c in sharded),
        "bit_identical_panel": all(c["digest_panel"] == single["digest_panel"]
                                   for c in sharded),
        "rerun_identical": all(c["rerun_identical"] for c in children),
    }
    skipped = {}
    if builds:
        cold, warm = sharded
        checks.update({
            "cache_populated": warm["cache_entries"] > 0,
            # the cold child starts on an empty directory and builds
            # kernel 1; the warm relaunch finds it there and builds nothing
            "cache_hit_on_relaunch":
                cold["builds"] > 0 and cold["build_hits"] == 0
                and warm["builds"] == 0 and warm["build_hits"] > 0,
            "cache_cuts_compile": warm["build_s"] < 0.6 * cold["build_s"],
        })
    else:
        skipped = dict.fromkeys(("sharded_warm",) + CACHE_CHECKS,
                                NO_BUILD_ON_CPU)
    child_keys = ("n_shards", "device", "wall_first_s", "wall_second_s",
                  "launch_first_s", "launch_second_s", "steps",
                  "kernel1_launches", "builds", "build_hits", "build_s",
                  "rerun_identical", "cache_entries")
    report = {"host_devices": host_devices, "tiny": tiny,
              "dispatch": dispatch, "device": str(device),
              "checks": checks, "skipped": skipped,
              "ok": all(checks.values())}
    for name, c in zip(("single", "sharded_cold", "sharded_warm"),
                       children):
        report[name] = {k: c[k] for k in child_keys}
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--child", action="store_true",
                    help="run one measured workload process")
    ap.add_argument("--smoke", action="store_true",
                    help="orchestrate single/cold/warm children and "
                         "check bit-identity and the build cache")
    ap.add_argument("--single", action="store_true",
                    help="(child) run the plain single-device path")
    ap.add_argument("--host-devices", type=int, default=2,
                    help="shards of a sharded run (on one card they run "
                         "one after another on it)")
    ap.add_argument("--dispatch", default="devices",
                    choices=["devices", "shard_map"],
                    help="devices = contiguous shards a device; shard_map "
                         "= run_cells_hetero(mesh=...), padded to a "
                         "multiple of the shards; both bit-identical")
    ap.add_argument("--cache-dir", default=None,
                    help="kernel build directory of a child")
    ap.add_argument("--tiny", action="store_true",
                    help="shrunken workload (the subprocess test)")
    ap.add_argument("--device", default=None,
                    help="device of the shards (default: the CUDA device)")
    ap.add_argument("--out", default=None, help="write the JSON report")
    args = ap.parse_args(argv)

    if args.child:
        report = child_main(args)
    elif args.smoke:
        report = run_smoke(args.host_devices, tiny=args.tiny,
                           dispatch=args.dispatch, device=args.device)
        print(json.dumps(report, indent=1))
        if not report["ok"]:
            print("sweep smoke FAILED", file=sys.stderr)
            return 1
        print("sweep smoke OK: sharded launch bit-identical to "
              "single-device"
              + ("; kernel builds "
                 f"{report['sharded_cold']['build_s']}s cold -> "
                 f"{report['sharded_warm']['build_s']}s warm"
                 if "sharded_warm" in report else ""))
    else:
        print("choose --child or --smoke", file=sys.stderr)
        return 2

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, default=repr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
