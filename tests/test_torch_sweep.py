"""The port's sharded sweep launcher (repro_torch.launch.sweep) and the
simulator's sharded entry on the CPU, where a mesh is one device named
more than once (launch.mesh.make_sweep_mesh(n, device="cpu")).

* ``_shard_bounds``, and ``pad_batch`` against the reference's on the
  same numpy trees;
* run_cells_hetero split over two CPU shards, on the cell and the lane
  axis, through both dispatches, bit-identical to the plain call;
* launch_scale_grid with a launcher, then ``.results()``, equal to the
  blocking run; run_candidates with a launcher bit-identical to without;
* the tiny measured workload's rows held to the JAX package's
  (``jax_reference.json["sweep_tiny"]``: iteration counts equal, times
  within 2%);
* the kernel build directory's resolution;
* the launcher's own smoke in a subprocess (``--smoke --tiny --device
  cpu``).

Nothing here forces a host device count, sets XLA_FLAGS or a compile
cache, or imports the reference's launch layer.
"""
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.fabric import simulator as jsim  # noqa: E402
from repro_torch.core import bench, congestion as cong  # noqa: E402
from repro_torch.core.fabric import simulator as sim  # noqa: E402
from repro_torch.core.fabric import systems  # noqa: E402
from repro_torch.core.mitigation import score as mscore  # noqa: E402
from repro_torch.core.mitigation import search as msearch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import sweep  # noqa: E402
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                         "jax_reference.json")
CELLS = [("cresco8", 8), ("cresco8", 12)]
# chunks of 512 steps: these cells finish inside one, a quarter of the
# default's steps; each comparison runs one chunk size on both sides
GRID_KW = dict(n_iters=6, warmup=2, chunk=512)
TIME_REL = 0.02


def _rows_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for f in ("system", "n_nodes", "vector_bytes", "profile", "n_iters"):
            assert getattr(ra, f) == getattr(rb, f)
        for f in ("t_uncongested_s", "t_congested_s", "ratio"):
            va, vb = getattr(ra, f), getattr(rb, f)
            assert va == vb or (np.isnan(va) and np.isnan(vb)), \
                (f, va, vb)  # bit-identical, not approx


def test_shard_bounds():
    assert sweep._shard_bounds(10, 4) == [(0, 3), (3, 6), (6, 8), (8, 10)]
    assert sweep._shard_bounds(4, 4) == [(0, 1), (1, 2), (2, 3), (3, 4)]
    # fewer items than devices: empty shards are skipped
    assert sweep._shard_bounds(2, 8) == [(0, 1), (1, 2)]
    assert [hi - lo for lo, hi in sweep._shard_bounds(17, 4)] \
        == [5, 4, 4, 4]


def _trees():
    rng = np.random.RandomState(3)
    return [({"a": np.arange(10).reshape(5, 2), "b": np.ones(5)}, 4, 0),
            ({"a": np.arange(10).reshape(5, 2), "b": np.ones(5)}, 5, 0),
            ({"x": np.arange(6).reshape(2, 3)}, 2, 1),
            ({"x": rng.rand(3, 5, 2), "y": rng.randint(0, 9, (3, 5))}, 4, 1),
            ({"x": rng.rand(7, 2)}, 3, 0)]


def test_pad_batch_matches_reference():
    for tree, multiple, axis in _trees():
        got = sim.pad_batch(tree, multiple, axis=axis)
        want = jsim.pad_batch(tree, multiple, axis=axis)
        assert sorted(got) == sorted(want)
        for k in tree:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        if tree["x" if "x" in tree else "a"].shape[axis] % multiple == 0:
            assert got is tree  # already a multiple: returned as it is
    # torch leaves and the engine's own structures pad the same way
    tree, multiple, axis = _trees()[3]
    got = sim.pad_batch({k: torch.as_tensor(v) for k, v in tree.items()},
                        multiple, axis=axis)
    want = sim.pad_batch(tree, multiple, axis=axis)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def _hetero_inputs():
    sysp = systems.get_system("cresco8")
    cases = [bench.build_case(sysp, n, "ring_allgather", "incast")
             for _, n in CELLS]
    dims, stacked = bench.bucket_stack([c.geom for c in cases])
    rows = []
    for case in cases:
        dt = bench.choose_dt(case.topo, case.n_victims, 1 << 20, case.lat())
        rows.append(sim.stack_params([
            case.cell_params(1 << 20, prof, dt, n_flows=dims.n_flows)
            for prof in (cong.no_congestion(), cong.steady(),
                         cong.bursty(0.5e-3, 0.2e-3))]))
    return stacked, sim.stack_params(rows)


def test_pad_batch_on_engine_inputs():
    stacked, params = _hetero_inputs()
    g = sim.pad_batch(stacked, 3)
    assert g.paths.shape[0] == 3
    assert torch.equal(g.paths[2], stacked.paths[0])
    p = sim.pad_batch(params, 2, axis=1)
    assert p.dt.shape == (2, 4)
    assert torch.equal(p.bytes_per_iter[:, 3], params.bytes_per_iter[:, 0])
    assert sim.pad_batch(params, 3, axis=1) is params


RUN_KW = dict(chunk=512, max_chunks=40, stride=8)


@functools.lru_cache(maxsize=None)
def _plain_hetero_run():
    stacked, params = _hetero_inputs()
    return sim.run_cells_hetero(stacked, params, 6, device="cpu", **RUN_KW)


@pytest.mark.parametrize("shard_axis,dispatch,n_shards", [
    ("cell", "devices", 2), ("lane", "devices", 2),
    ("cell", "shard_map", 3), ("lane", "shard_map", 2)])
def test_sharded_run_bit_identical_to_plain(shard_axis, dispatch, n_shards):
    """run_cells_hetero split over CPU shards (padded where the batch is
    not a multiple of the shards) equals the plain call bit for bit."""
    stacked, params = _hetero_inputs()
    kw = RUN_KW
    plain = _plain_hetero_run()
    mesh = make_sweep_mesh(n_shards, device="cpu")
    launcher = sweep.device_launcher(mesh, shard_axis=shard_axis,
                                     dispatch=dispatch)
    out = launcher(stacked, params, 6, **kw)
    assert sorted(out) == sorted(plain)
    for k in plain:
        np.testing.assert_array_equal(plain[k], np.asarray(out[k]),
                                      err_msg=k)


def test_launch_then_collect_matches_blocking_run():
    """launch_scale_grid through a two-shard launcher, then .results(),
    gives exactly what the blocking single-device run gives."""
    args = (CELLS, "ring_allgather", "incast", [1 << 20], [cong.steady()])
    mesh = make_sweep_mesh(2, device="cpu")
    pending = bench.launch_scale_grid(
        *args, launcher=sweep.device_launcher(mesh), **GRID_KW)
    assert isinstance(pending.out, sweep.ShardedOut)
    blocking = bench.run_scale_grid(*args, device="cpu", **GRID_KW)
    _rows_equal(pending.results(), blocking)
    # one system with a mesh takes the scale-batched route, same rows
    one = bench.run_grid(systems.get_system("cresco8"), 8, *args[1:],
                         mesh=mesh, **GRID_KW)
    _rows_equal(one, blocking[:1])


def test_run_candidates_launcher_parity():
    """The mitigation search's lanes split over two CPU shards give the
    plain call's runs bit for bit."""
    panel = mscore.panel_from_scenario(quick=True)[:1]
    cands = [msearch.default_candidate(),
             msearch.Candidate(policy=1, name="ecmp")]
    plain = msearch.run_candidates(panel, cands, device="cpu", **GRID_KW)
    mesh = make_sweep_mesh(2, device="cpu")
    sharded = msearch.run_candidates(panel, cands, mesh=mesh, **GRID_KW)
    assert len(plain) == len(sharded) == len(panel) * len(cands)
    for ra, rb in zip(plain, sharded):
        assert (ra.cell, ra.candidate) == (rb.cell, rb.candidate)
        assert ra.ratio == rb.ratio or (np.isnan(ra.ratio)
                                        and np.isnan(rb.ratio))
        assert ra.victim_bytes == rb.victim_bytes
        assert ra.aggr_bytes == rb.aggr_bytes
        assert ra.sim_time_s == rb.sim_time_s


def _close(a, b):
    return a == b or abs(a / b - 1) <= TIME_REL


@pytest.mark.usefixtures("one_thread")
def test_tiny_workload_matches_jax_rows():
    """The launcher's tiny workload on one device against the JAX
    package's rows: the scale grid's iteration counts equal and times
    within 2%; the panel's runs with times and ratios within 2%."""
    with open(REFERENCE) as f:
        want = json.load(f)["sweep_tiny"]
    got = sweep.run_workload(None, tiny=True, device="cpu")
    assert got["n_shards"] == 1 and got["steps"] > 0
    assert len(got["results_scale"]) == len(want["results_scale"])
    for g, w in zip(got["results_scale"], want["results_scale"]):
        for f in ("system", "n_nodes", "victim", "aggressor", "profile",
                  "vector_bytes", "dnf"):
            assert g[f] == w[f], f
        assert list(g["n_iters"]) == list(w["n_iters"])
        for f in ("t_uncongested_s", "t_congested_s", "ratio"):
            assert _close(g[f], w[f]), (f, g[f], w[f])
    assert len(got["runs_panel"]) == len(want["runs_panel"])
    for g, w in zip(got["runs_panel"], want["runs_panel"]):
        assert (g["cell"], g["candidate"], g["dnf"]) \
            == (w["cell"], w["candidate"], w["dnf"])
        for f in ("t_uncongested_s", "t_congested_s", "ratio",
                  "sim_time_s"):
            assert _close(g[f], w[f]), (f, g[f], w[f])


def test_mesh_defaults_to_the_card():
    assert make_sweep_mesh(2, device="cpu") == (torch.device("cpu"),) * 2
    assert make_sweep_mesh(device="cpu") == (torch.device("cpu"),)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_sweep_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["--child", "--single", "--tiny"])


def test_build_dir_resolution(tmp_path, monkeypatch):
    """The kernel build directory: the one given to use_build_dir, else
    build/ at the repository root; library paths follow it."""
    monkeypatch.setattr(_build, "_build_dir", None)
    assert _build.build_dir() == _build.BUILD_DIR
    assert _build.use_build_dir(tmp_path / "arg") == tmp_path / "arg"
    src = _build.CSRC / "fabric_step.cu"
    assert _build.library_path(src).parent == tmp_path / "arg"
    assert _build.use_build_dir(None) == _build.BUILD_DIR


def test_sweep_smoke_tiny_on_cpu(tmp_path):
    """The launcher's own smoke, end to end: fresh children on one device
    and in two shards, bit-identical digests and reruns; on the CPU the
    warm child and the build-cache checks are left out and say why."""
    out = tmp_path / "smoke.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sweep", "--smoke",
         "--tiny", "--device", "cpu", "--out", str(out)],
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["ok"], report["checks"]
    assert report["checks"] == {"sharded": True, "bit_identical_scale": True,
                                "bit_identical_panel": True,
                                "rerun_identical": True}
    assert sorted(report["skipped"]) == ["cache_cuts_compile",
                                         "cache_hit_on_relaunch",
                                         "cache_populated", "sharded_warm"]
    assert "sharded_warm" not in report
    assert report["sharded_cold"]["n_shards"] == 2
    assert report["sharded_cold"]["builds"] == 0
