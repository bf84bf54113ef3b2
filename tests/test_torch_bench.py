"""The slice end to end: scenario registry -> bench -> batched engine ->
step core, in the port (on the CPU) against the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bench as jbench  # noqa: E402
from repro.core import congestion as jcong  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import congestion as tcong  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402


def test_run_point_matches_jax():
    """nanjing_ecmp, 8 nodes, 4 MiB under steady AlltoAll: the Fig. 4
    ECMP cell at a short protocol."""
    kw = dict(n_iters=6, warmup=2, max_steps=8192)
    want = jbench.run_point(jsystems.get_system("nanjing_ecmp"), 8,
                            "alltoall", "alltoall", 4 << 20, jcong.steady(),
                            **kw)
    got = tbench.run_point(tsystems.get_system("nanjing_ecmp"), 8,
                           "alltoall", "alltoall", 4 << 20, tcong.steady(),
                           device="cpu", **kw)
    assert got.n_iters == want.n_iters
    assert not got.dnf and got.warmup_ok == want.warmup_ok
    np.testing.assert_allclose(got.ratio, want.ratio, rtol=1e-3)
    np.testing.assert_allclose(got.t_uncongested_s, want.t_uncongested_s,
                               rtol=1e-3)
    np.testing.assert_allclose(got.t_congested_s, want.t_congested_s,
                               rtol=1e-3)
    assert got.ratio < 0.85  # ECMP collisions cost the victim


def test_registry_matches_for_fig4_fig5():
    for quick in (False, True):
        js, ts = jscen.get("fig4_nslb", quick), tscen.get("fig4_nslb", quick)
        assert ts.points == js.points
        assert (ts.n_iters, ts.warmup) == (js.n_iters, js.warmup)
        js, ts = jscen.get("fig5_steady", quick), \
            tscen.get("fig5_steady", quick)
        assert (ts.n_iters, ts.warmup) == (js.n_iters, js.warmup)
        assert len(ts.grids) == len(js.grids)
        for tg, jg in zip(ts.grids, js.grids):
            assert (tg.system, tg.n_nodes, tg.aggressor, tg.sizes,
                    tg.victim, tg.phased, tg.cells) == \
                (jg.system, jg.n_nodes, jg.aggressor, jg.sizes, jg.victim,
                 jg.phased, jg.cells)
            assert [p.label() for p in tg.profiles] == \
                [p.label() for p in jg.profiles]
            for tp, jp in zip(tg.profiles, jg.profiles):
                np.testing.assert_array_equal(tp.params(), jp.params())


def test_result_row_matches():
    grid = tscen.get("fig5_steady", True).grids[0]
    jgrid = jscen.get("fig5_steady", True).grids[0]
    r = tbench.BenchResult("cresco8", 16, "ring_allgather", "alltoall",
                           "steady", 32768.0, 16e-6, 21.2e-6, 0.7544, 1.0,
                           (25, 25), (("victim", 1e-5, 25),))
    assert tscen.result_row(grid, r) == jscen.result_row(jgrid, r)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    sysp = tsystems.get_system("nanjing_ecmp")
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run_point(sysp, 8, "alltoall", "alltoall", 4 << 20,
                         tcong.steady(), n_iters=2, warmup=0)
    scen = tscen.get("fig5_steady", True)
    with pytest.raises(RuntimeError, match="CUDA"):
        tscen.run_grid_spec(scen, scen.grids[0])
    # a cell list runs through the scale-batched engine, on the card too
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run_grid([(sysp, 8)], 0, "alltoall", "alltoall", (1.0,),
                        (tcong.steady(),))
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.run_scale_grid([("nanjing_ecmp", 8)], "alltoall", "alltoall",
                              (1.0,), (tcong.steady(),), n_iters=2)


def test_topology_cache_keys_on_builder_identity():
    """A preset given another builder under the same name gets that
    builder's topology, as in the reference (tests/test_grid.py)."""
    import dataclasses

    tbench.clear_topology_cache()
    jbench.clear_topology_cache()
    sysp = tsystems.get_system("cresco8")
    base = tbench.machine_topology(sysp)
    assert tbench.machine_topology(sysp) is base
    lumi_builder = tsystems.get_system("lumi").make_topology
    modified = dataclasses.replace(sysp, make_topology=lumi_builder)
    alt = tbench.machine_topology(modified)
    want = jbench.machine_topology(dataclasses.replace(
        jsystems.get_system("cresco8"),
        make_topology=jsystems.get_system("lumi").make_topology))
    assert alt is not base
    assert len(alt.caps) == len(want.caps) == 5072
    assert alt.name == want.name
    # tpu_pod's builder is a closure over (nx, ny) that ignores n
    links = [len(tbench.machine_topology(tsystems.tpu_pod(nx, ny), 16).caps)
             for nx, ny in ((4, 4), (8, 2))]
    want_links = [len(jbench.machine_topology(jsystems.tpu_pod(nx, ny),
                                              16).caps)
                  for nx, ny in ((4, 4), (8, 2))]
    assert links == want_links == [64, 48]
    tbench.clear_topology_cache()
    assert tbench.machine_topology(sysp) is not base
