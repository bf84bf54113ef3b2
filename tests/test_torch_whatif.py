"""The port's what-if service (repro_torch.runtime.whatif) on the CPU: the
seven contracts of tests/test_whatif.py on the port, and the port held to
repro.runtime.whatif on the same two queries.

* coalesced waves score every (cell, candidate) bit for bit as the
  one-query servers do, over queries in different geometry buckets;
* one engine call a wave; budget, drained and duplicate semantics; the
  agent tier; query validation;
* the lane-sharded launcher (launch.sweep.whatif_launcher) on two CPU
  shards bit-identical to no launcher;
* against the JAX package: equal winners, frontiers, finish reasons,
  evaluations and WhatIfStats counts, every table entry within 2%.

No server here gets a ``cache_dir``. The engine runs in chunks of 512
steps (the reference's tests keep the default 2,048): every cell here
finishes inside 512 steps, so a wave costs a quarter of the steps, and
each comparison is made at one chunk on both sides.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.mitigation import agents as jagents  # noqa: E402
from repro.runtime import whatif as jwhatif  # noqa: E402
from repro_torch.core.mitigation import agents  # noqa: E402
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402
from repro_torch.launch.sweep import whatif_launcher  # noqa: E402
from repro_torch.runtime import whatif  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

KW = dict(n_iters=5, warmup=2, max_steps=50_000, chunk=512)
KiB = float(1 << 10)
RATIO_REL = 0.02
STAT_KEYS = ("queries_done", "waves", "coalesced_calls", "lanes", "evals",
             "table_hits")

CANDS = tuple(agents.grid_candidates(("hol_factor", "md"),
                                     points_per_knob=2))


def _queries(pkg=whatif, cands=CANDS):
    qa = pkg.WhatIfQuery(system="cresco8", n_nodes=8,
                         vector_bytes=256 * KiB, agent="grid",
                         candidates=cands, budget=8, batch=2)
    # another scale: another geometry bucket than qa's
    qb = pkg.WhatIfQuery(system="cresco8", n_nodes=16,
                         vector_bytes=128 * KiB, agent="grid",
                         candidates=cands[:3], budget=8, batch=2)
    return qa, qb


def _table(res):
    return {s.candidate: (s.ratio_min, s.ratio_mean, s.aggr_gbps,
                          s.jain, s.t_base_worst_rel)
            for s in res.scores}


def _server(**kw):
    return whatif.WhatIfServer(device="cpu", **KW, **kw)


@functools.lru_cache(maxsize=None)
def _coalesced():
    """The two queries in one server, wave by wave: ``(server, results,
    engine calls each wave)``."""
    srv = _server(max_batch=4)
    uids = [srv.submit(q) for q in _queries()]
    calls = []
    while srv.active or srv.queue:
        calls0 = srv.stats.coalesced_calls
        srv.step_wave()
        calls.append(srv.stats.coalesced_calls - calls0)
        if len(calls) > 20:
            pytest.fail("server failed to drain")
    return srv, tuple(srv.result(u) for u in uids), tuple(calls)


@functools.lru_cache(maxsize=None)
def _serial_results():
    out = []
    for q in _queries():
        srv = _server(max_batch=1)
        uid = srv.submit(q)
        srv.run_until_drained()
        out.append(srv.result(uid))
    return tuple(out)


def test_coalesced_bit_identical_to_serial_mixed_buckets():
    """Two queries in different buckets sharing waves score every (cell,
    candidate) bit for bit as the one-query servers do, with the same
    winners and frontiers."""
    srv, (ra, rb), _ = _coalesced()
    stats = srv.stats
    r1, r2 = _serial_results()
    assert _table(ra) == _table(r1)
    assert _table(rb) == _table(r2)
    assert ra.winner.candidate == r1.winner.candidate
    assert rb.winner.candidate == r2.winner.candidate
    assert [s.candidate for s in ra.frontier] \
        == [s.candidate for s in r1.frontier]
    assert ra.finish_reason == rb.finish_reason == "drained"
    assert stats.queries_done == 2
    assert stats.coalesced_calls < ra.evals + rb.evals
    assert stats.lanes > 0 and stats.evals == ra.evals + rb.evals


def test_coalesced_waves_one_call_per_wave():
    """Each wave is one run_candidate_rows call, however many queries are
    active."""
    srv, _, calls = _coalesced()
    assert all(c <= 1 for c in calls) and sum(calls) >= 1
    assert srv.stats.waves == len(calls)
    assert srv.stats.coalesced_calls == sum(calls)


@pytest.mark.usefixtures("one_thread")
def test_budget_exhaustion_returns_best_so_far():
    q = whatif.WhatIfQuery(system="cresco8", n_nodes=8,
                           vector_bytes=128 * KiB, agent="grid",
                           candidates=CANDS, budget=2, batch=2)
    srv = _server(max_batch=2)
    uid = srv.submit(q)
    assert srv.poll(uid) is None
    with pytest.raises(KeyError):
        srv.result(uid)
    srv.run_until_drained()
    res = srv.result(uid)
    assert res.finish_reason == "budget"
    assert res.evals == 2  # stopped at the budget, not the grid size
    assert len(res.scores) == 3  # default + 2 evaluated candidates
    assert res.winner is not None and np.isfinite(res.objective)
    assert res.winner_candidate is None \
        or res.winner_candidate.label() == res.winner.candidate


@pytest.mark.usefixtures("one_thread")
def test_duplicate_candidates_cost_nothing():
    dup = (CANDS[0], CANDS[1], CANDS[0], CANDS[1], CANDS[2])
    q = whatif.WhatIfQuery(system="cresco8", n_nodes=8,
                           vector_bytes=128 * KiB, agent="grid",
                           candidates=dup, budget=10, batch=2)
    srv = _server()
    uid = srv.submit(q)
    srv.run_until_drained()
    res = srv.result(uid)
    assert res.finish_reason == "drained"
    assert res.evals == 3  # the two repeats were served from the memo
    assert len(res.scores) == 4  # default + 3 distinct candidates


@pytest.mark.usefixtures("one_thread")
def test_agent_tier_budget_and_observe():
    q = whatif.WhatIfQuery(system="cresco8", n_nodes=8,
                           vector_bytes=128 * KiB, agent="cmaes",
                           knobs=("hol_factor", "md"), budget=6, batch=3,
                           seed=0)
    srv = _server()
    uid = srv.submit(q)
    srv.run_until_drained()
    res = srv.result(uid)
    assert res.finish_reason == "budget" and res.evals >= 6
    assert len(res.frontier) >= 1
    assert res.scores and np.isfinite(res.objective)


def test_query_validation():
    with pytest.raises(KeyError):
        whatif.WhatIfQuery(system="cresco8", n_nodes=8, agent="annealing")
    with pytest.raises(ValueError):
        whatif.WhatIfQuery(system="cresco8", n_nodes=8, budget=0)
    with pytest.raises(ValueError):
        whatif.WhatIfQuery(system="cresco8", n_nodes=8, batch=0)
    with pytest.raises(KeyError):
        whatif.WhatIfQuery(system="not_a_fabric", n_nodes=8)


def test_whatif_launcher_helper():
    """launch.sweep.whatif_launcher splits each wave's lanes over a mesh;
    two CPU shards are bit-identical to no launcher."""
    q = whatif.WhatIfQuery(system="cresco8", n_nodes=8,
                           vector_bytes=128 * KiB, agent="grid",
                           candidates=CANDS[:2], budget=4, batch=2)
    mesh = make_sweep_mesh(2, device="cpu")
    srv = whatif.WhatIfServer(launcher=whatif_launcher(mesh), **KW)
    uid = srv.submit(q)
    srv.run_until_drained()
    plain = _server()
    uid2 = plain.submit(q)
    plain.run_until_drained()
    assert _table(srv.result(uid)) == _table(plain.result(uid2))
    assert srv.stats == dataclasses.replace(plain.stats,
                                            wall_s=srv.stats.wall_s)


def test_server_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    srv = whatif.WhatIfServer(**KW)
    srv.submit(_queries()[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        srv.step_wave()


def _close(a, b):
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return a == b or abs(a / b - 1) <= RATIO_REL


def test_matches_the_jax_service():
    """The reference test's two queries, coalesced, through both
    packages: equal winners, frontiers, finish reasons, evaluations and
    stats counts; every table entry within 2%."""
    jcands = tuple(jagents.grid_candidates(("hol_factor", "md"),
                                           points_per_knob=2))
    assert [c.label() for c in jcands] == [c.label() for c in CANDS]
    got_srv, got_results, _ = _coalesced()
    want_srv = jwhatif.WhatIfServer(max_batch=4, **KW)
    want_uids = [want_srv.submit(q) for q in _queries(jwhatif, jcands)]
    want_stats = want_srv.run_until_drained()
    for k in STAT_KEYS:
        assert getattr(got_srv.stats, k) == getattr(want_stats, k), k
    for got, wu in zip(got_results, want_uids):
        want = want_srv.result(wu)
        assert got.winner.candidate == want.winner.candidate
        assert [s.candidate for s in got.frontier] \
            == [s.candidate for s in want.frontier]
        assert got.finish_reason == want.finish_reason
        assert got.evals == want.evals
        gt, wt = _table(got), _table(want)
        assert sorted(gt) == sorted(wt)
        for cand, row in gt.items():
            for a, b in zip(row, wt[cand]):
                assert _close(a, float(b)), (cand, row, wt[cand])
