"""The paper's figure runner on the port (on the CPU) against the JAX
package: Fig. 1's network time, Fig. 3's goodput trace, one Fig. 6 bursty
grid (``tests/test_torch_pt_run.py`` drives the ``pt_run`` entry
point)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import pt_fig1_breakdown, pt_fig3_sawtooth  # noqa: E402
from benchmarks import pt_fig6_bursty  # noqa: E402
from repro.core import bench as jbench  # noqa: E402
from repro.core import congestion as jcong  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro.core.collectives import wire_bytes_model  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402

MiB = 2 ** 20
# the smoke run's phase tolerances: times and goodput within 2%; CV within
# 2% relative or 2e-3 absolute
RTOL = 0.02
CV_ATOL = 2e-3


def test_registry_matches_for_fig1_fig3_fig6():
    for quick in (False, True):
        for name in ("fig1_breakdown", "fig3_sawtooth"):
            js, ts = jscen.get(name, quick), tscen.get(name, quick)
            assert ts.points == js.points
            assert (ts.n_iters, ts.warmup, ts.grids) == \
                (js.n_iters, js.warmup, ())
        js, ts = jscen.get("fig6_bursty", quick), \
            tscen.get("fig6_bursty", quick)
        assert (ts.n_iters, ts.warmup) == (js.n_iters, js.warmup)
        assert len(ts.grids) == len(js.grids) == 6
        for tg, jg in zip(ts.grids, js.grids):
            assert (tg.system, tg.n_nodes, tg.aggressor, tg.sizes,
                    tg.victim) == (jg.system, jg.n_nodes, jg.aggressor,
                                   jg.sizes, jg.victim)
            assert [p.label() for p in tg.profiles] == \
                [p.label() for p in jg.profiles]
            for tp, jp in zip(tg.profiles, jg.profiles):
                np.testing.assert_array_equal(tp.params(), jp.params())
    assert (tscen.BURSTS_MS, tscen.PAUSES_MS, tscen.FIG6_SIZES) == \
        (jscen.BURSTS_MS, jscen.PAUSES_MS, jscen.FIG6_SIZES)


def test_fig1_run_size_matches_jax_network_time():
    got, = pt_fig1_breakdown.run_sizes([MiB], device="cpu")
    want = jbench.run_point(jsystems.get_system("haicgu_ib"), 8,
                            "ring_allreduce", "", MiB,
                            jcong.no_congestion(), n_iters=15, warmup=3)
    assert tuple(got["n_iters"]) == tuple(want.n_iters) == (15, 15)
    np.testing.assert_allclose(got["t_network_us"],
                               want.t_uncongested_s * 1e6, rtol=RTOL)
    assert got["wire_bytes"] == wire_bytes_model("ring_all_reduce", 8,
                                                 MiB)["bytes"]
    for k in ("t_reduce_us", "t_memcpy_us", "t_fused_reduce_us"):
        assert np.isfinite(got[k]) and got[k] > 0, k
    assert 0 < got["compute_fraction"] < 1
    assert got["device"] == "cpu"
    assert pt_fig1_breakdown.fused_tile(MiB) == (64, 512)
    assert pt_fig1_breakdown.fused_tile(128 * MiB) == (8192, 512)


def test_fig3_goodput_trace_matches_jax():
    v = 16 * MiB
    got, = tbench.goodput_traces([(tsystems.get_system("haicgu_ce8850"), 4,
                                   "ring_allgather", v)], n_iters=25,
                                 device="cpu")
    want = jbench.goodput_trace(jsystems.get_system("haicgu_ce8850"), 4,
                                "ring_allgather", v, n_iters=25)
    assert got.n_done == want.n_done == 25
    g = pt_fig3_sawtooth.steady_part(got.victim_rate_trace)
    w = pt_fig3_sawtooth.steady_part(np.asarray(want.victim_rate_trace))
    assert len(g) == len(w) > 0
    np.testing.assert_allclose(g.mean(), w.mean(), rtol=RTOL)
    cv_g, cv_w = g.std() / g.mean(), w.std() / w.mean()
    assert abs(cv_g - cv_w) <= max(RTOL * cv_w, CV_ATOL), (cv_g, cv_w)
    row, = pt_fig3_sawtooth.run_points([("haicgu_ce8850", v)], device="cpu")
    assert row["trace_len"] == len(w) and row["n_iters"] == 25
    np.testing.assert_allclose(row["cv"], cv_w, rtol=RTOL)


def test_fig6_bursty_grid_matches_jax():
    """cresco8/64/incast at 32 KiB, bursts 0.5 and 8 ms, pause 0.2 ms."""
    sizes = (32 * 2 ** 10,)
    kw = dict(n_iters=5, warmup=1)
    want = jbench.run_grid(jsystems.get_system("cresco8"), 64,
                           "ring_allgather", "incast", sizes,
                           jscen._bursty_grid((0.5, 8.0), (0.2,)), **kw)
    got = tbench.run_grid(tsystems.get_system("cresco8"), 64,
                          "ring_allgather", "incast", sizes,
                          tscen._bursty_grid((0.5, 8.0), (0.2,)),
                          device="cpu", **kw)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.profile == w.profile
        assert g.n_iters == w.n_iters and not g.dnf
        np.testing.assert_allclose(g.t_uncongested_s, w.t_uncongested_s,
                                   rtol=RTOL)
        np.testing.assert_allclose(g.t_congested_s, w.t_congested_s,
                                   rtol=RTOL)


def test_fig6_grid_at_size_cuts_the_registry_grid():
    g = pt_fig6_bursty.grid_at_size("leonardo", "incast", 2 * MiB)
    assert (g.system, g.n_nodes, g.sizes) == ("leonardo", 64, (2 * MiB,))
    assert len(g.profiles) == 9
    rows = [{"system": "leonardo", "aggressor": "incast", "burst_ms": b,
             "pause_ms": p, "ratio": r}
            for b, p, r in ((0.5, 0.2, 0.9), (0.5, 8.0, 0.95),
                            (8.0, 0.2, 0.6))]
    assert pt_fig6_bursty.short_vs_long_pause(rows, "leonardo") == \
        (0.5, 0.9, 0.95)
    assert pt_fig6_bursty.short_vs_long_pause(rows, "lumi") is None
