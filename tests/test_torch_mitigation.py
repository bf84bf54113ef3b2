"""The port's mitigation lab and autotune against the JAX package: the
candidate spaces and bounds, a small panel's scores and winner, the
Pareto frontier and winner guard on fixed scores, the gradient tier's
Adam history, each search agent's first generation under a fixed seed,
and the analytic schedule choice. Also the guard that keeps autograd away
from kernel 1, which has no gradient. Small cells on the CPU, where
kernel 1 runs its plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import autotune as jtune  # noqa: E402
from repro.core import bench as jbench  # noqa: E402
from repro.core import congestion as jcong  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro.core.fabric.routing import (POLICY_ADAPTIVE,  # noqa: E402
                                       POLICY_ECMP, POLICY_FLOWLET,
                                       POLICY_NSLB)
from repro.core.mitigation import agents as jagents  # noqa: E402
from repro.core.mitigation import score as jscore  # noqa: E402
from repro.core.mitigation import search as jsearch  # noqa: E402
from repro_torch.core import autotune as ttune  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import congestion as tcong  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402
from repro_torch.core.mitigation import agents as tagents  # noqa: E402
from repro_torch.core.mitigation import score as tscore  # noqa: E402
from repro_torch.core.mitigation import search as tsearch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

RATIO_REL = 0.02
HISTORY_REL = 1e-4
KNOBS = ("hol_factor", "md", "rai_frac")


def _spaces(pkg):
    return [
        (pkg.CCSpace.of(md=(0.5, 0.8), rai_frac=(0.02,)),
         pkg.RoutingSpace(policies=(POLICY_NSLB, POLICY_FLOWLET),
                          flowlet_gaps_s=(50e-6, 200e-6))),
        (pkg.CCSpace.of(hol_factor=(0.45, 0.9), kind=(1, 3)),
         pkg.RoutingSpace()),
        (pkg.CCSpace(), pkg.RoutingSpace(policies=(POLICY_ECMP,
                                                   POLICY_ADAPTIVE))),
    ]


def test_expand_and_bounds_match_reference():
    for (jc, jr), (tc, tr) in zip(_spaces(jsearch), _spaces(tsearch)):
        got, want = tsearch.expand(tc, tr), jsearch.expand(jc, jr)
        assert [(c.policy, c.flowlet_gap_s, c.cc, c.label()) for c in got] \
            == [(c.policy, c.flowlet_gap_s, c.cc, c.label()) for c in want]
    for name, value in (("md", 0.1), ("md", 0.95), ("nonsense", 1.0),
                        ("flowlet_gap_s", 1.0), ("kind", 3)):
        errs = []
        for pkg in (jsearch, tsearch):
            try:
                errs.append(pkg.check_bounds(name, value))
            except (KeyError, ValueError) as e:
                errs.append(type(e))
        assert errs[0] == errs[1], (name, value)
    assert tsearch.GRAD_KNOBS == jsearch.GRAD_KNOBS
    with pytest.raises(KeyError):
        tsearch.gradient_refine(None, None, ["kind"])


def _panel(search, cong, systems):
    return [search.PanelCell(
        name="ecmp8", system=systems.get_system("nanjing_ecmp"), n_nodes=8,
        victim="ring_allgather", aggressor="alltoall",
        vector_bytes=float(1 << 20), profile=cong.steady())]


@pytest.mark.usefixtures("one_thread")
def test_score_table_matches_jax():
    """Two candidates (NSLB routing; a HOL-isolation knob) and the
    default on the Fig. 4 ECMP cell, one batch."""
    kw = dict(n_iters=5, warmup=2, max_steps=20_000)
    want = jscore.score_table(
        _panel(jsearch, jcong, jsystems),
        [jsearch.Candidate(policy=POLICY_NSLB),
         jsearch.Candidate(cc=(("hol_factor", 0.45),))], **kw)
    got = tscore.score_table(
        _panel(tsearch, tcong, tsystems),
        [tsearch.Candidate(policy=POLICY_NSLB),
         tsearch.Candidate(cc=(("hol_factor", 0.45),))], device="cpu", **kw)
    assert [s.candidate for s in got] == [s.candidate for s in want]
    for g, w in zip(got, want):
        for ax in ("ratio_min", "ratio_mean", "aggr_gbps", "jain",
                   "t_base_worst_rel"):
            np.testing.assert_allclose(getattr(g, ax), getattr(w, ax),
                                       rtol=RATIO_REL, err_msg=ax)
        assert g.n_dnf == w.n_dnf == 0
    assert tscore.pick_winner(got).candidate == \
        jscore.pick_winner(want).candidate == "nslb"
    assert [s.candidate for s in tscore.pareto_frontier(got)] == \
        [s.candidate for s in jscore.pareto_frontier(want)]


def _fixed_scores(score):
    mk = lambda n, rmin, aggr, jain, rel: score.CandidateScore(  # noqa
        candidate=n, ratio_min=rmin, ratio_mean=rmin, aggr_gbps=aggr,
        jain=jain, t_base_worst_rel=rel)
    return [mk("dominated", 0.5, 10.0, 0.9, 1.0),
            mk("balanced", 0.9, 80.0, 0.95, 1.0),
            mk("throttler", 0.95, 1.0, 1.0, 1.0),
            mk("taxed", 0.99, 60.0, 0.99, 1.3),
            mk("dnf", float("nan"), float("nan"), float("nan"), 1.0)]


def test_pareto_frontier_and_winner_match_reference():
    got, want = _fixed_scores(tscore), _fixed_scores(jscore)
    assert [s.candidate for s in tscore.pareto_frontier(got)] == \
        [s.candidate for s in jscore.pareto_frontier(want)]
    for slack in (0.02, 0.5):
        assert tscore.pick_winner(got, slack).candidate == \
            jscore.pick_winner(want, slack).candidate
    assert tscore.pick_winner(got).candidate == "throttler"


def _grad_case(bench, cong, systems):
    case = bench.build_case(systems.get_system("haicgu_ce8850"), 8,
                            "ring_allgather", "incast")
    dt = bench.choose_dt(case.topo, case.n_victims, 8 << 20, case.lat())
    return case.geom, case.cell_params(8 << 20, cong.steady(), dt)


@pytest.mark.usefixtures("one_thread")
def test_gradient_refine_matches_jax():
    """Two Adam steps over 800 engine steps of the CE8850 incast cell:
    the objective history within 1e-4 relative, the knobs moved alike."""
    knobs = ["md", "rai_frac", "kmin"]
    want = jsearch.gradient_refine(*_grad_case(jbench, jcong, jsystems),
                                   knobs, steps=2, n_steps=800)
    got = tsearch.gradient_refine(*_grad_case(tbench, tcong, tsystems),
                                  knobs, steps=2, n_steps=800, device="cpu")
    np.testing.assert_allclose(got["history"], want["history"],
                               rtol=HISTORY_REL)
    assert got["history"][1] < got["history"][0]  # it descends
    for k in knobs:
        np.testing.assert_allclose(got["knobs"][k], want["knobs"][k],
                                   rtol=HISTORY_REL)


def _step_core_args(device, grad):
    B, F, H, L1, n_src, n_sw = 2, 3, 2, 5, 2, 3
    t = lambda *s: torch.ones(s, device=device)  # noqa: E731
    i = lambda *s: torch.zeros(s, dtype=torch.int32,  # noqa: E731
                               device=device)
    inject = t(B, F).requires_grad_(grad)
    return (i(B, F, H), inject, i(F), t(B, F), t(B, L1), t(B, L1), t(L1),
            i(L1), i(L1), t(B), t(B), t(B), t(B), t(B)), \
        dict(n_src=n_src, n_sw=n_sw)


def test_step_core_refuses_a_gradient_on_the_card(monkeypatch):
    """Kernel 1 has no gradient: a non-CPU input that requires one raises
    under core='kernel' (a meta tensor stands in for the card's)."""
    args, kw = _step_core_args("meta", grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.fabric_step_core(*args, **kw)
    with torch.no_grad():  # no gradient wanted: the dispatch goes on
        with pytest.raises(ValueError, match="no fabric_step_core"):
            ops.fabric_step_core(*args, **kw)
    # a kernel launch that the guard let through would be a bug
    monkeypatch.setattr(ops._fs, "fabric_step_core",
                        lambda *a, **k: pytest.fail("kernel launched"))
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.fabric_step_core(*args, core="kernel", **kw)
    # on the CPU the plain version carries the gradient
    args, kw = _step_core_args("cpu", grad=True)
    out = ops.fabric_step_core(*args, **kw)
    assert out["achieved"].grad_fn is not None


@pytest.mark.parametrize("kind", ["random", "ga", "cmaes", "bo"])
def test_agent_first_generation_matches_reference(kind):
    for seed in (0, 3):
        want = jagents.make_agent(kind, knobs=KNOBS, batch=8, seed=seed)
        got = tagents.make_agent(kind, knobs=KNOBS, batch=8, seed=seed)
        wp, gp = want.propose([]), got.propose([])
        assert [(c.policy, c.cc) for c in gp] == \
            [(c.policy, c.cc) for c in wp]
        # a second generation after the same observations
        for ag, props, pkg in ((want, wp, jagents), (got, gp, tagents)):
            ag.observe([pkg.Observation(
                c, -float(np.sum((ag.to_vector(c) - 0.3) ** 2)), None)
                for c in props])
        assert [c.cc for c in got.propose(got.history)] == \
            [c.cc for c in want.propose(want.history)]


def test_agent_grid_and_objective_match_reference():
    assert [(c.policy, c.cc) for c in tagents.grid_candidates(KNOBS)] == \
        [(c.policy, c.cc) for c in jagents.grid_candidates(KNOBS)]
    for s_t, s_j in zip(_fixed_scores(tscore), _fixed_scores(jscore)):
        assert tagents.objective(s_t) == jagents.objective(s_j) \
            or (np.isinf(tagents.objective(s_t))
                and np.isinf(jagents.objective(s_j)))


def test_autotune_analytic_tier_matches_reference():
    fields = dataclasses.astuple
    for kind, algos in jtune.CANDIDATES.items():
        assert ttune.CANDIDATES[kind] == algos
        for n in (2, 8, 64):
            for v in (1 << 10, 1 << 20, 64 << 20):
                for algo in algos:
                    for cf in (1.0, 3.0):
                        assert fields(ttune.predict_analytic(
                            kind, algo, n, v, congestion_factor=cf)) == \
                            fields(jtune.predict_analytic(
                                kind, algo, n, v, congestion_factor=cf))
                assert fields(ttune.choose_schedule(kind, n, v)) == \
                    fields(jtune.choose_schedule(kind, n, v))
    for g in (1e3, 1e9):
        assert fields(ttune.choose_pod_strategy(g, 4)) == \
            fields(jtune.choose_pod_strategy(g, 4))


def test_agents_in_lock_step_equal_agents_one_by_one():
    """run_agents scores every agent's generation in one batch; each
    trajectory equals the agent's run alone (cells do not see the batch
    around them)."""
    panel = _panel(tsearch, tcong, tsystems)
    kw = dict(n_iters=2, warmup=1, max_steps=4096, chunk=256,
              device="cpu")
    knobs = ("hol_factor", "md")

    def fresh():
        return [tagents.make_agent(k, knobs=knobs, batch=2, seed=1)
                for k in ("random", "cmaes")]
    alone = [tagents.run_agent(a, panel, budget=4, **kw) for a in fresh()]
    evs = [tagents.PanelEvaluator(panel, **kw) for _ in range(2)]
    together = tagents.run_agents(fresh(), evs, budget=4)
    for a, b in zip(alone, together):
        assert (a.evals, a.best, a.best_label) == \
            (b.evals, b.best, b.best_label)
    assert [ev.calls for ev in evs] == [2, 2]
