"""The port's beyond-paper scenario families against the JAX package: the
nine registry entries field for field, the victim label of a cache key,
grids of the multi-job, phased, random-telegraph and multi-tenant
families (iteration counts equal, times within 2%), and the figure
runner's ``scenarios`` and ``faults`` on a cut-down registry. Small
sizes on the CPU, where every kernel call runs its plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bench as jbench  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402

KiB = 2 ** 10
# steps a chunk in the grid runs here: a cell stops within this many
# steps of its last iteration, in both packages alike
CHUNK = 64
FAMILIES = ("ramp_onset", "random_telegraph", "multi_tenant",
            "phased_collectives", "multi_job_mix", "scale_sweep",
            "mixed_topology", "link_fault", "intra_node")


def _profile_fields(p):
    return (p.label(), p.kind, p.burst_s, p.pause_s, p.seed,
            p.node_cap_frac, tuple(dataclasses.astuple(e) for e in p.faults),
            tuple((c.label(), w) for c, w in p.components))


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", FAMILIES)
def test_registry_entries_match_reference(name, quick):
    ts, js = tscen.get(name, quick), jscen.get(name, quick)
    assert (ts.name, ts.description, ts.n_iters, ts.warmup, ts.points) == \
        (js.name, js.description, js.n_iters, js.warmup, js.points)
    assert len(ts.grids) == len(js.grids) > 0
    for tg, jg in zip(ts.grids, js.grids):
        assert (tg.system, tg.n_nodes, tg.aggressor, tg.sizes, tg.victim,
                tg.phased, tg.cells) == \
            (jg.system, jg.n_nodes, jg.aggressor, jg.sizes, jg.victim,
             jg.phased, jg.cells)
        assert [_profile_fields(p) for p in tg.profiles] == \
            [_profile_fields(p) for p in jg.profiles]
        for tp, jp in zip(tg.profiles, jg.profiles):
            np.testing.assert_array_equal(tp.params(), jp.params())
            if jp.faults:
                np.testing.assert_array_equal(tp.fault_params(),
                                              jp.fault_params())
        assert [dataclasses.asdict(j) for j in tg.jobs] == \
            [dataclasses.asdict(j) for j in jg.jobs]


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("name", ["fleet_replay", "mitigation_panel",
                                  "mitigation_routing"])
def test_replay_and_mitigation_entries_match_reference(name, quick):
    """The fleet replay's points and the mitigation lab's panels, field
    for field (fleet_replay has points and no grids)."""
    ts, js = tscen.get(name, quick), jscen.get(name, quick)
    assert (ts.name, ts.description, ts.n_iters, ts.warmup, ts.points) == \
        (js.name, js.description, js.n_iters, js.warmup, js.points)
    assert len(ts.grids) == len(js.grids)
    assert bool(ts.grids) != (name == "fleet_replay")
    for tg, jg in zip(ts.grids, js.grids):
        assert (tg.system, tg.n_nodes, tg.aggressor, tg.sizes, tg.victim,
                tg.phased, tg.cells) == \
            (jg.system, jg.n_nodes, jg.aggressor, jg.sizes, jg.victim,
             jg.phased, jg.cells)
        assert [_profile_fields(p) for p in tg.profiles] == \
            [_profile_fields(p) for p in jg.profiles]
        for tp, jp in zip(tg.profiles, jg.profiles):
            np.testing.assert_array_equal(tp.params(), jp.params())
            if jp.faults:
                np.testing.assert_array_equal(tp.fault_params(),
                                              jp.fault_params())
        assert [dataclasses.asdict(j) for j in tg.jobs] == \
            [dataclasses.asdict(j) for j in jg.jobs]


def test_registry_names_match_reference_but_one():
    """All 19 of the reference's entries, collective_microbench (the last
    to come) with the reference's sizes."""
    assert set(jscen.SCENARIOS) == set(tscen.SCENARIOS)
    assert len(tscen.SCENARIOS) == 19
    for quick in (False, True):
        assert tscen.get("collective_microbench", quick).microbench_sizes \
            == jscen.get("collective_microbench", quick).microbench_sizes


def test_mix_jobs_match_reference():
    for kind in ("training_vs_training", "training_vs_incast",
                 "four_tenant"):
        assert [dataclasses.asdict(j) for j in tscen._mix_jobs(kind)] == \
            [dataclasses.asdict(j) for j in jscen._mix_jobs(kind)]
    with pytest.raises(KeyError):
        tscen._mix_jobs("nope")


def test_resolve_victim_label_matches_reference():
    for victim, phased in (("ring_allgather", False), ("alltoall", True),
                           ("", False)):
        for jobs in (None, "phased", "flat"):
            args = [victim, phased]
            kw = {}
            if jobs is not None:
                j = dict(name="a", collective="ring_allreduce",
                         phased=jobs == "phased")
                kw = {"jobs": [jtraffic.JobSpec(**j)]}
                tkw = {"jobs": [ttraffic.JobSpec(**j)]}
            else:
                tkw = {}
            assert tbench.resolve_victim_label(*args, **tkw) == \
                jbench.resolve_victim_label(*args, **kw)


def _hold(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.system, g.n_nodes, g.victim, g.aggressor, g.profile,
                g.vector_bytes) == (w.system, w.n_nodes, w.victim,
                                    w.aggressor, w.profile, w.vector_bytes)
        assert g.n_iters == w.n_iters and g.dnf == w.dnf
        for f in ("t_uncongested_s", "t_congested_s"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=0.02, err_msg=f)
        assert [(n, k) for n, _, k in g.job_times] == \
            [(n, k) for n, _, k in w.job_times]
        np.testing.assert_allclose([t for _, t, _ in g.job_times],
                                   [t for _, t, _ in w.job_times],
                                   rtol=0.02)


def _both(name, index, n_iters=3, n_nodes=16, sizes=(32 * KiB,)):
    """One quick grid of a family on both packages, cut to ``n_nodes``
    nodes, ``sizes`` and ``n_iters`` iterations (warmup 1), in chunks of
    CHUNK steps."""
    out = []
    for scen_mod, bench_mod, kw in ((jscen, jbench, {}),
                                    (tscen, tbench, {"device": "cpu"})):
        g = scen_mod.get(name, True).grids[index]
        out.append(bench_mod.run_grid(
            bench_mod.get_system(g.system), n_nodes, g.victim, g.aggressor,
            sizes, g.profiles, n_iters=n_iters, warmup=1, phased=g.phased,
            jobs=list(g.jobs) or None, chunk=CHUNK, **kw))
    return out[1], out[0]


@pytest.mark.parametrize("index", [0, 1])
def test_multi_job_mix_grid_matches_reference(index):
    """The ``jobs=`` path: job_times names and counts equal, times within
    2%, for the training-vs-training and training-vs-incast mixes."""
    got, want = _both("multi_job_mix", index)
    _hold(got, want)
    assert got[0].job_times[0][0] == ["train_a", "train"][index]
    assert got[0].aggressor == tscen.get("multi_job_mix",
                                         True).grids[index].aggressor


def test_phased_collectives_pair_matches_reference():
    """The first flat/phased pair (leonardo, incast, AlltoAll victim) at
    16 nodes and 32 KiB: both rows held to the reference, the phased row
    labelled so."""
    rows = []
    for index in (0, 1):
        got, want = _both("phased_collectives", index)
        _hold(got, want)
        rows += got
    assert [r.victim for r in rows] == ["alltoall", "alltoall+phased"]


@pytest.mark.parametrize("name", ["random_telegraph", "multi_tenant"])
def test_envelope_family_grid_matches_reference(name):
    got, want = _both(name, 0, sizes=(2 ** 20,))
    _hold(got, want)
    np.testing.assert_allclose([g.ratio for g in got],
                               [w.ratio for w in want], rtol=0.02)


def _cut_down(monkeypatch):
    """Every family of ``scenarios`` and ``faults`` at one small grid (a
    flat/phased pair at two): 8 nodes, or the first cell of a
    scale-batched grid at 16, 32 KiB (1 MiB for the fault families, whose
    checks need the link to carry bytes), 2 iterations (4 for
    intra_node; 60 for link_fault, so a run reaches well into the fault
    windows, which open at 0.2 ms), in chunks of CHUNK steps."""
    import functools

    orig = dict(tscen.SCENARIOS)
    monkeypatch.setattr(tbench, "run_grid",
                        functools.partial(tbench.run_grid, chunk=CHUNK))

    def small(name, keep):
        def make(quick=False):
            return _small(orig[name](True), name, keep)
        return make
    for name in FAMILIES:
        keep = 2 if name == "phased_collectives" else 1
        monkeypatch.setitem(tscen.SCENARIOS, name, small(name, keep))


def _small(sc, name, keep):
    """``sc`` (either package's quick entry) cut as ``_cut_down`` says."""
    size = 2 ** 20 if name in ("link_fault", "intra_node") else 32 * KiB
    grids = []
    for g in sc.grids[:keep]:
        g = dataclasses.replace(
            g, cells=tuple((s, 16) for s, _ in g.cells[:1]),
            n_nodes=8 if g.n_nodes else 0, sizes=(size,))
        grids.append(g)
    n_iters = {"link_fault": 60, "intra_node": 4}.get(name, 2)
    return dataclasses.replace(sc, grids=tuple(grids), n_iters=n_iters,
                               warmup=1)


def _jax_fault_panel(monkeypatch, tmp_path):
    """A reference file whose ``fault_panel`` row is JAX's own on the
    cut-down panel: benchmarks/fault_scenarios.py's quick fault panel on
    the reference registry cut as the port's is."""
    import json

    from benchmarks import fault_scenarios
    from repro.core.mitigation import score as jscore

    name = jscore.FAULT_PANEL_SCENARIO
    orig = jscen.SCENARIOS[name]
    monkeypatch.setitem(jscen.SCENARIOS, name,
                        lambda quick=False: _small(orig(True), name, 1))
    cells = [c.name for c in jscore.panel_from_scenario(name, quick=True)]
    winners = fault_scenarios.fault_panel(True)["winners"]
    path = tmp_path / "jax_reference.json"
    path.write_text(json.dumps({"fault_panel": {"quick": {
        "cells": cells, "winners": winners}}}))
    return str(path), winners


def test_pt_run_accepts_scenarios_and_faults(tmp_path, capsys,
                                             monkeypatch):
    """``pt_run --only scenarios,faults`` runs both drivers (here on a
    cut-down registry on the CPU): every family's rows and counts, the
    phased-vs-flat deltas, the fault checks, the fault panel's winners
    (held to JAX's on the same cut-down panel) and the monitor demo's
    pins."""
    from benchmarks import pt_fault_scenarios, pt_run

    _cut_down(monkeypatch)
    ref, winners = _jax_fault_panel(monkeypatch, tmp_path)
    monkeypatch.setattr(pt_fault_scenarios, "REFERENCE", ref)
    capsys.readouterr()
    assert pt_run.main(["--only", "scenarios,faults", "--quick", "--device",
                        "cpu", "--cache-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    for name in FAMILIES:
        assert (tmp_path / f"{name}.csv").exists(), name
        assert f"# {name}: " in out and "kernel-1 launches" in out, name
    assert "# phased check: phased-vs-flat ratio delta" in out
    assert "inertness: all-none table & inf-cap node stage" in out \
        and "bit-identical" in out
    for check in ("flap check", "dying-optic check", "intra-node check"):
        assert f"# {check}:" in out and "MISMATCH" not in out, check
    for check in ("fault-panel check", "monitor demo"):
        line = next(x for x in out.splitlines() if x.startswith(f"# {check}"))
        assert line.endswith("REPRODUCED"), line
    assert f"winners equal JAX's {winners}" in out


def test_scale_sweep_runs_the_full_ladder(monkeypatch, capsys, tmp_path):
    """pt_new_scenarios runs the reference's full scale_sweep entry as it
    is, its 512-node alltoall cells included, with no note; and kernel 1
    takes the bucket those four cells pad into (65,536 flows; geometries
    only, no engine run)."""
    from benchmarks import pt_new_scenarios
    from repro_torch.core.fabric import systems
    from repro_torch.kernels import fabric_step

    full = tscen.get("scale_sweep", False)
    got = []
    monkeypatch.setattr(pt_new_scenarios, "scenario_rows",
                        lambda scen, **kw: got.append((scen, kw)) or [])
    pt_new_scenarios.main(device="cpu", cache_dir=str(tmp_path),
                          families=("scale_sweep",))
    (scen, kw), = got
    assert scen == full and "comment" not in kw
    assert "# scale_sweep: 0 rows" in capsys.readouterr().out
    cells = [c for g in scen.grids if g.aggressor == "alltoall"
             for c in g.cells if c[1] == 512]
    assert sorted(s for s, _ in cells) == ["cresco8", "haicgu_ib",
                                           "leonardo", "lumi"]
    dims, _ = tbench.bucket_stack([
        tbench.build_case(systems.get_system(s), n, "ring_allgather",
                          "alltoall").geom for s, n in cells])
    assert dims.n_flows == fabric_step.MAX_FLOWS == 65536
    cfg = fabric_step.launch_config(8, dims.n_flows, dims.max_hops,
                                    dims.n_links + 1, dims.n_src, dims.n_sw,
                                    with_aux=True)
    assert cfg.cluster == 8 and cfg.workspace


def _small_scenario(scen_mod, cong_mod):
    steady = (cong_mod.steady(),)
    return scen_mod.Scenario(
        name="small", description="two small grids", n_iters=4, warmup=1,
        grids=(scen_mod.Grid("cresco8", 8, "incast", (64 * KiB,), steady),
               scen_mod.Grid("cresco8+lumi", 0, "alltoall", (64 * KiB,),
                             steady, cells=(("cresco8", 8), ("lumi", 8)))))


def test_run_scenario_matches_reference():
    """run_scenario runs every grid of a scenario in order (a
    single-system grid and a scale-batched one), rows held to the
    reference's: iteration counts equal, times within 2%."""
    from repro.core import congestion as jcong
    from repro_torch.core import congestion as tcong

    got = list(tscen.run_scenario(_small_scenario(tscen, tcong),
                                  device="cpu"))
    want = list(jscen.run_scenario(_small_scenario(jscen, jcong)))
    assert [(r.system, r.n_nodes) for r in got] == \
        [("cresco8", 8), ("cresco8", 8), ("lumi", 8)]
    _hold(got, want)
