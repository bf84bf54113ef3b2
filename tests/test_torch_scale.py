"""The port's scale-batched engine (paper Figs. 7-8) against the JAX
package: the padding helpers array for array, a bucket-padded cell bit
for bit equal to itself run alone, ``run_scale_grid`` against the
reference's on small cells, the Fig. 7-8 registry, and the figure runner.
Small sizes (16-32 nodes) on the CPU, where every kernel call runs its
plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bench as jbench  # noqa: E402
from repro.core import congestion as jcong  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.core.fabric import simulator as jsim  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import congestion as tcong  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.core.fabric import simulator as tsim  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402

MiB = 2 ** 20
# (system, n_nodes, aggressor): a bucket mixing topologies, scales and an
# incast with an alltoall geometry
CELLS = (("cresco8", 16, "incast"), ("lumi", 32, "alltoall"),
         ("leonardo", 16, "incast"))


def _programs(pkg_traffic):
    jobs = [pkg_traffic.JobSpec("victim", "ring_allgather", MiB,
                                nodes=tuple(range(0, 12, 2)), phased=True),
            pkg_traffic.JobSpec("aggressor", "incast",
                                nodes=tuple(range(1, 12, 2)), endless=True,
                                envelope_gated=True, sweep_bytes=False)]
    return pkg_traffic.compile_programs(jobs)


@pytest.mark.parametrize("pad", [(0, 0, 0), (40, 1, 3)])
def test_pad_rows_and_pad_program_match_jax(pad):
    jprog, tprog = _programs(jtraffic), _programs(ttraffic)
    F, J, P = tprog.n_flows, len(tprog.n_phases), tprog.phase_gap.shape[1]
    dims = dict(n_flows=F + pad[0], n_jobs=J + pad[1], n_phases=P + pad[2])
    jp, tp = jtraffic.pad_program(jprog, **dims), \
        ttraffic.pad_program(tprog, **dims)
    for f in ("src", "dst", "bytes_per_phase", "flow_job", "flow_phase",
              "n_phases", "phase_gap", "env_gated", "sweep_mask"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
        assert getattr(tp, f).dtype == getattr(jp, f).dtype, f
    ttraffic.check_program(tp)  # exact on the valid prefix
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(ttraffic.pad_rows(x, 5, -1.0),
                                  jtraffic.pad_rows(x, 5, -1.0))
    if pad[0]:
        with pytest.raises(ValueError, match="padding job"):
            ttraffic.pad_program(tprog, n_flows=F + 1, n_jobs=J,
                                 n_phases=P)


def test_build_program_flowset_pad_to_matches_jax():
    jobs = [dict(name="victim", collective="ring_allgather",
                 vector_bytes=MiB, nodes=(0, 2, 4, 6)),
            dict(name="aggressor", collective="alltoall",
                 nodes=(1, 3, 5, 7), endless=True, envelope_gated=True,
                 sweep_bytes=False)]
    out = []
    for traffic, cong, systems in ((jtraffic, jcong, jsystems),
                                   (ttraffic, tcong, tsystems)):
        sysp = systems.get_system("nanjing_ecmp")
        topo = sysp.make_topology(8)
        out.append(cong.build_program_flowset(
            topo, [traffic.JobSpec(**j) for j in jobs],
            routing_mode=sysp.static_routing, k_max=sysp.k_max,
            pad_to=(30, 3, 4)))
    for f in ("paths", "n_paths", "src_id", "bytes_per_iter", "flow_job",
              "flow_phase", "n_phases", "phase_gap", "is_victim",
              "host_caps"):
        np.testing.assert_array_equal(np.asarray(getattr(out[1], f)),
                                      np.asarray(getattr(out[0], f)), f)


def _cases(cells=CELLS):
    """The port's and the reference's cases of each cell."""
    t = [tbench.build_case(tsystems.get_system(s), n, "ring_allgather", a)
         for s, n, a in cells]
    j = [jbench.build_case(jsystems.get_system(s), n, "ring_allgather", a)
         for s, n, a in cells]
    return t, j


def _arrays(geom):
    return {k: np.asarray(getattr(geom, k)) for k in tsim.GEOMETRY_FIELDS}


@pytest.mark.parametrize("pow2", [False, True])
def test_bucket_pad_stack_match_jax(pow2):
    """bucket_dims (with and without the power-of-two policy),
    pad_geometry and stack_geometries give the reference's arrays."""
    t, j = _cases()
    jdims = jsim.bucket_dims([c.geom for c in j],
                             round_up=jbench._round_pow2 if pow2 else None)
    tdims = tsim.bucket_dims([c.geom for c in t],
                             round_up=tbench._round_pow2 if pow2 else None)
    assert dataclasses.asdict(tdims) == dataclasses.asdict(jdims)
    for tc, jc in zip(t, j):
        assert dataclasses.asdict(tsim.geometry_dims(tc.geom)) \
            == dataclasses.asdict(jsim.geometry_dims(jc.geom))
    tp = [tsim.pad_geometry(c.geom, tdims) for c in t]
    jp = [jsim.pad_geometry(c.geom, jdims) for c in j]
    for a, b in zip(tp, jp):
        want = _arrays(b)
        for k, v in _arrays(a).items():
            np.testing.assert_array_equal(v, want[k].astype(v.dtype), k)
        assert a.meta() == {"L": b.L, "n_sw": b.n_sw, "n_src": b.n_src,
                            "n_jobs": b.n_jobs, "intra_node": b.intra_node}
    ts, js = tsim.stack_geometries(tp), jsim.stack_geometries(jp)
    assert ts.per_cell and ts.paths.shape[0] == len(CELLS)
    want = _arrays(js)
    for k, v in _arrays(ts).items():
        np.testing.assert_array_equal(v, want[k].astype(v.dtype), k)
    with pytest.raises(ValueError, match="differing meta"):
        tsim.stack_geometries([c.geom for c in t])
    with pytest.raises(ValueError, match="n_links"):
        tsim.pad_geometry(t[1].geom, dataclasses.replace(tdims, n_links=3))


def _sub_cells(case, sizes, profiles, n_flows=None):
    dts = tbench._cell_dts(case, sizes, len(profiles), None, case.lat())
    cells = [(float(v), p) for v in sizes
             for p in [tcong.no_congestion(), *profiles]]
    return tsim.stack_params([case.cell_params(v, p, d, n_flows=n_flows)
                              for (v, p), d in zip(cells, dts)])


def test_padded_cell_bit_equal_to_itself_alone():
    """Each cell of a bucket mixing incast and alltoall geometries gives,
    on the plain path, every output bit for bit as it gives run alone:
    its iteration times, counters, delay accumulator, delivered bytes
    (its real flows) and goodput trace."""
    t, _ = _cases()
    dims, stacked = tbench.bucket_stack([c.geom for c in t])
    # pad flows take a source no real flow of any member has
    assert dims.n_src == max(c.geom.n_src for c in t) + 1
    for k, case in enumerate(t):
        F = case.geom.n_flows
        assert int(stacked.src_id[k, :F].max()) < dims.n_src - 1
        assert bool((stacked.src_id[k, F:] == dims.n_src - 1).all())
    sizes, profiles = (MiB,), (tcong.bursty(0.5e-3, 0.2e-3),
                               tcong.steady())
    kw = dict(chunk=64, max_chunks=40, stride=8, device="cpu")
    params = tsim.stack_params([_sub_cells(c, sizes, profiles, dims.n_flows)
                                for c in t])
    out = tsim.run_cells_hetero(stacked, params, 4, **kw)
    for k, case in enumerate(t):
        alone = tsim.run_cells(case.geom, _sub_cells(case, sizes, profiles),
                               4, **kw)
        F, J = case.geom.n_flows, case.geom.n_jobs
        for name, want in alone.items():
            got = out[name][k]
            if name == "fbytes":
                assert not got[:, F:].any()  # pad flows deliver nothing
                got = got[:, :F]
            elif name in ("t_done", "it"):
                got = got[:, :J]
            assert got.shape == want.shape, name
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
                f"cell {k} {name}"
        assert alone["it"][:, 0].min() >= 4


def test_victim_sums_ignore_trailing_zeros():
    """The victim sums' pairwise tree gives the same bits with zeros
    appended (a bucket's pad flows), which Tensor.sum does not promise."""
    rng = np.random.RandomState(0)
    for n in (1, 7, 31, 63, 100):
        x = torch.as_tensor(rng.rand(3, n) * 1e9, dtype=torch.float32)
        pad = torch.cat([x, torch.zeros(3, 2 * n + 5)], 1)
        a, = tsim.victim_sums([x], n)
        b, = tsim.victim_sums([pad], pad.shape[1])
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), x.double().sum(1).numpy(),
                                   rtol=1e-6)


def test_run_scale_grid_matches_jax():
    """Two small cells of different systems and scales in one bucket:
    equal iteration counts, times and ratios within 2% of the reference's
    run_scale_grid, results in the reference's order."""
    cells = [("cresco8", 16), ("lumi", 32)]
    args = ("ring_allgather", "incast", (2 * MiB,))
    kw = dict(n_iters=6, warmup=2, max_steps=16384)
    want = jbench.run_scale_grid(cells, *args, (jcong.bursty(2e-3, 0.2e-3),),
                                 **kw)
    got = tbench.run_scale_grid(cells, *args, (tcong.bursty(2e-3, 0.2e-3),),
                                device="cpu", **kw)
    via_grid = tbench.run_grid(cells, 0, *args,
                               (tcong.bursty(2e-3, 0.2e-3),), device="cpu",
                               **kw)
    assert len(got) == len(want) == 2
    for g, w, v in zip(got, want, via_grid):
        assert (g.system, g.n_nodes, g.aggressor, g.profile) == \
            (w.system, w.n_nodes, w.aggressor, w.profile)
        assert g.n_iters == w.n_iters and not g.dnf
        for f in ("t_uncongested_s", "t_congested_s", "ratio"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=0.02, err_msg=f)
        assert (v.ratio, v.n_iters) == (g.ratio, g.n_iters)


def test_fig7_fig8_grids_match_reference():
    for quick in (False, True):
        js = jscen.get("fig7_fig8_scale", quick)
        ts = tscen.get("fig7_fig8_scale", quick)
        assert (ts.name, ts.n_iters, ts.warmup) == \
            (js.name, js.n_iters, js.warmup)
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


def test_grid_spec_with_cells_runs_scale_grid():
    """A registry grid with ``cells`` runs through run_scale_grid; its
    rows carry the keys the CSV cache expects, cell by cell."""
    from benchmarks.pt_common import expected_grid_keys
    grid = tscen.Grid("scale", 0, "incast", (2 * MiB,),
                      (tcong.bursty(2e-3, 8e-3),),
                      cells=(("cresco8", 16), ("lumi", 16)))
    sc = tscen.Scenario("t", "", (grid,), n_iters=4, warmup=1)
    rows = [tscen.result_row(grid, r)
            for r in tscen.run_grid_spec(sc, grid, device="cpu")]
    keys = [(r["system"], str(r["n_nodes"]), r["victim"], r["aggressor"],
             str(float(r["vector_bytes"])), r["profile"]) for r in rows]
    assert keys == expected_grid_keys(grid)


def test_pt_run_accepts_fig7_fig8(tmp_path, capsys, monkeypatch):
    """``pt_run --only fig7_fig8`` runs the figure script (here on a reduced
    grid on the CPU): its heatmaps, the Fig. 7 check and the engine's
    counts."""
    from benchmarks import pt_run

    quick = tscen.SCENARIOS["fig7_fig8_scale"]

    def small(q=False):
        sc = quick(True)
        grid = dataclasses.replace(sc.grids[0],
                                   cells=(("cresco8", 16), ("cresco8", 32)))
        return dataclasses.replace(sc, grids=(grid,), n_iters=4, warmup=1)
    monkeypatch.setitem(tscen.SCENARIOS, "fig7_fig8_scale", small)
    assert pt_run.main(["--only", "fig7_fig8", "--quick", "--device", "cpu",
                        "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert (tmp_path / "fig7_fig8_scale.csv").exists()
    assert "# Fig. 7/8 — cresco8 32 nodes, incast" in out
    assert "kernel-1 launches" in out
    assert "fig7_fig8[cresco8:incast:16:" in out


def test_goodput_traces_as_one_batch_equal_each_alone():
    """Fig. 3's points as one padded batch (bench.goodput_traces): each
    trace, iteration count and delay bit for bit as the point run alone
    (its goodput_case through simulator.run_cell)."""
    pts = [(tsystems.get_system(s), 4, "ring_allgather", float(MiB))
           for s in ("haicgu_ce8850", "nanjing_nslb")]
    batch = tbench.goodput_traces(pts, n_iters=25, device="cpu")
    for p, b in zip(pts, batch):
        geom, params = tbench.goodput_case(*p)
        out = tsim.run_cell(geom, params, 25, chunk=2048, max_chunks=98,
                            stride=8, device="cpu")
        a = tsim.summarize(out, n_iters=25, warmup=5, dt=20e-6, chunk=2048,
                           stride=8)
        assert len(a.victim_rate_trace) > 0 and a.n_done == b.n_done == 25
        np.testing.assert_array_equal(a.victim_rate_trace.view(np.int32),
                                      b.victim_rate_trace.view(np.int32))
        np.testing.assert_array_equal(a.iter_times, b.iter_times)
        assert a.mean_qdelay_s == b.mean_qdelay_s
