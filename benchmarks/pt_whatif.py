"""What-if coalescing demo on the port, as ``benchmarks/whatif_bench.py``
runs it on the JAX package: K = 3 mixed-bucket what-if queries
(cresco8/8 at 256 KiB, cresco8/16 at 128 KiB, lumi/16 at 256 KiB)
answered coalesced (one server, shared waves) and then serially (one
server each).

Checks: every query's score table is bit-identical between the two, and
the coalesced server runs strictly fewer engine calls than the serial
ones; each query's finish reason and evaluations and the stats' calls
and lanes equal the JAX package's, every table entry is within
``RATIO_REL`` of JAX's, and each winner and frontier is JAX's up to
candidates that tie in JAX's table within ``TIE_REL``, whose order the
last bits of float32 sums decide (``jax_reference.json["whatif_quick"]``
or ``["whatif_full"]``, ``benchmarks/pt_jax_reference.py --only
whatif``). ``--quick`` runs 4 candidates a query at 5 iterations (2 of
warmup), the full run 9 at 10 (3). Prints the walls, calls and lanes
and each query's winner; exits non-zero when a check fails. The agents'
convergence race is ``pt_mitigation_lab.py``'s.

``PYTHONPATH=src python -m benchmarks.pt_whatif [--quick] [--device cpu]``
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import Dict, List

from benchmarks.pt_common import REFERENCE, device_name
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.core.mitigation import agents, search
from repro_torch.kernels import fabric_step
from repro_torch.runtime import whatif

KiB = float(1 << 10)
KNOBS = ("hol_factor", "md")
# a table entry against JAX's
RATIO_REL = 0.02
# two candidates whose three Pareto axes agree this closely in JAX's table
# tie: which one ranks first is then decided by the last bits of float32
# sums, where the port and JAX may differ (lumi/16 in the full demo:
# aggressor goodput 1599.97850 against 1599.97862, one float32 ulp)
TIE_REL = 1e-6
# the stats held equal to JAX's
STAT_KEYS = ("queries_done", "waves", "coalesced_calls", "lanes", "evals",
             "table_hits")


def queries(quick: bool) -> List[whatif.WhatIfQuery]:
    cands = tuple(agents.grid_candidates(
        KNOBS, points_per_knob=2 if quick else 3))
    return [
        whatif.WhatIfQuery(system="cresco8", n_nodes=8,
                           vector_bytes=256 * KiB, agent="grid",
                           candidates=cands, budget=len(cands), batch=2),
        whatif.WhatIfQuery(system="cresco8", n_nodes=16,
                           vector_bytes=128 * KiB, agent="grid",
                           candidates=cands, budget=len(cands), batch=2),
        whatif.WhatIfQuery(system="lumi", n_nodes=16,
                           vector_bytes=256 * KiB, agent="grid",
                           candidates=cands[:-1], budget=len(cands),
                           batch=2),
    ]


def engine_kw(quick: bool) -> dict:
    return dict(n_iters=5, warmup=2, max_steps=50_000) if quick \
        else dict(n_iters=10, warmup=3)


def table(res: whatif.WhatIfResult) -> Dict[str, tuple]:
    return {s.candidate: (s.ratio_min, s.ratio_mean, s.aggr_gbps, s.jain,
                          s.t_base_worst_rel) for s in res.scores}


def first_wave(quick: bool):
    """The coalesced server's first wave: ``(cells, rows)`` as
    ``search.run_candidate_rows`` gets them."""
    srv = whatif.WhatIfServer(max_batch=3, device="cpu", **engine_kw(quick))
    for q in queries(quick):
        srv.submit(q)
    _, cells, rows = srv.wave_rows()
    return cells, rows


def first_wave_inputs(quick: bool):
    """Kernel 1's batch in the first coalesced wave, built as the server
    builds it (search.candidate_rows_inputs): ``(stacked geometries,
    params)`` with (cell, lane) leading axes, on the CPU."""
    _, _, stacked, params = search.candidate_rows_inputs(*first_wave(quick))
    return stacked, params


def run(quick: bool, device) -> Dict:
    """Coalesced first, then serial; tables, calls, lanes and walls."""
    device = resolve_device(device)
    kw = dict(engine_kw(quick), device=device)
    qs = queries(quick)
    steps0, launches0 = sim.step_count, fabric_step.launches
    srv = whatif.WhatIfServer(max_batch=len(qs), **kw)
    uids = [srv.submit(q) for q in qs]
    t0 = time.perf_counter()
    stats = srv.run_until_drained()
    wall_coal = time.perf_counter() - t0
    coalesced = [srv.result(u) for u in uids]
    steps_coal = sim.step_count - steps0
    serial, serial_calls, serial_lanes = [], 0, 0
    t0 = time.perf_counter()
    for q in qs:
        one = whatif.WhatIfServer(max_batch=1, **kw)
        u = one.submit(q)
        one.run_until_drained()
        serial.append(one.result(u))
        serial_calls += one.stats.coalesced_calls
        serial_lanes += one.stats.lanes
    wall_serial = time.perf_counter() - t0
    return {
        "device": device_name(device),
        "bit_identical": all(table(a) == table(b)
                             for a, b in zip(coalesced, serial)),
        "stats": {k: v for k, v in dataclasses.asdict(stats).items()
                  if k != "wall_s"},
        "serial_calls": serial_calls, "serial_lanes": serial_lanes,
        "wall_coalesced_s": wall_coal, "wall_serial_s": wall_serial,
        "steps_coalesced": steps_coal,
        "steps": sim.step_count - steps0,
        "kernel1_launches": fabric_step.launches - launches0,
        "queries": [{"query": f"{q.system}-{q.n_nodes}",
                     "table": table(r), "winner": r.winner.candidate,
                     "frontier": [s.candidate for s in r.frontier],
                     "finish_reason": r.finish_reason, "evals": r.evals}
                    for q, r in zip(qs, coalesced)],
    }


def _close(a: float, b: float) -> bool:
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return a == b or abs(a / b - 1) <= RATIO_REL


def _tied(a, b) -> bool:
    """Two table rows whose Pareto axes (ratio_min, jain, aggr_gbps) agree
    within ``TIE_REL``."""
    return all(abs(a[i] - b[i]) <= TIE_REL * max(abs(a[i]), abs(b[i]))
               for i in (0, 2, 3))


def ranking_diffs(q: str, got: Dict, want: Dict) -> List[str]:
    """The winner and the frontier against JAX's: equal, or differing
    only between candidates that tie in JAX's table (:func:`_tied`); the
    frontier has JAX's members either way."""
    table, diffs = want["table"], []
    g, w = got["winner"], want["winner"]
    if g != w and not (g in table and _tied(table[g], table[w])
                       and table[g][4] <= 1.02):
        diffs.append(f"{q} winner: {g} != {w}")
    gf, wf = got["frontier"], want["frontier"]
    if sorted(gf) != sorted(wf):
        diffs.append(f"{q} frontier: {gf} != {wf}")
    else:
        pos = {c: i for i, c in enumerate(wf)}
        for i, a in enumerate(gf):
            for b in gf[i + 1:]:
                if pos[a] > pos[b] and not _tied(table[a], table[b]):
                    diffs.append(f"{q} frontier order: {a} before {b}")
    return diffs


def jax_agreement(out: Dict, quick: bool, reference: str = REFERENCE) -> Dict:
    """Each query's winner, frontier, finish reason and evaluations and
    the coalesced stats against the JAX package's run, every table entry
    within ``RATIO_REL``; a winner or frontier order may differ only
    between candidates that tie in JAX's table (``ties`` lists them)."""
    with open(reference) as f:
        want = json.load(f).get("whatif_quick" if quick else "whatif_full")
    if not want:
        return {"ok": False, "note": f"no JAX what-if rows in {reference}"}
    diffs, worst, ties = [], 0.0, []
    for got, w in zip(out["queries"], want["queries"]):
        q = got["query"]
        for k in ("finish_reason", "evals"):
            if got[k] != w[k]:
                diffs.append(f"{q} {k}: {got[k]} != {w[k]}")
        if got["winner"] != w["winner"] or got["frontier"] != w["frontier"]:
            ties.append({"query": q, "winner": got["winner"],
                         "jax_winner": w["winner"]})
        if sorted(got["table"]) != sorted(w["table"]):
            diffs.append(f"{q} candidates: {sorted(got['table'])} != "
                         f"{sorted(w['table'])}")
            continue
        for cand, row in got["table"].items():
            for a, b in zip(row, w["table"][cand]):
                if not _close(a, b):
                    diffs.append(f"{q} {cand}: {a} vs {b}")
                elif a != b and not math.isnan(a):
                    worst = max(worst, abs(a / b - 1))
        diffs += ranking_diffs(q, got, w)
    for k in STAT_KEYS:
        if out["stats"][k] != want["stats"][k]:
            diffs.append(f"stats {k}: {out['stats'][k]} != "
                         f"{want['stats'][k]}")
    if out["serial_calls"] != want["serial_calls"]:
        diffs.append(f"serial calls {out['serial_calls']} != "
                     f"{want['serial_calls']}")
    return {"ok": not diffs, "diffs": diffs, "worst_rel": worst,
            "ties": ties}


def report(out: Dict) -> None:
    print(f"# what-if coalescing on {out['device']}: "
          f"{len(out['queries'])} mixed-bucket queries")
    print(f"  bit-identical tables: {out['bit_identical']}")
    print(f"  coalesced calls {out['stats']['coalesced_calls']} vs serial "
          f"{out['serial_calls']}; lanes {out['stats']['lanes']} vs "
          f"{out['serial_lanes']}")
    print(f"  wall coalesced {out['wall_coalesced_s']:.2f}s, serial "
          f"{out['wall_serial_s']:.2f}s; {out['steps']} engine steps, "
          f"{out['kernel1_launches']} kernel-1 launches")
    for q in out["queries"]:
        print(f"  {q['query']}: winner {q['winner']} ({q['finish_reason']}, "
              f"{q['evals']} evals)")


def failures(out: Dict, agree: Dict) -> List[str]:
    failed = []
    if not out["bit_identical"]:
        failed.append("coalesced tables differ from the serial ones")
    if not out["stats"]["coalesced_calls"] < out["serial_calls"]:
        failed.append(f"{out['stats']['coalesced_calls']} coalesced calls "
                      f">= {out['serial_calls']} serial")
    if not agree["ok"]:
        failed.append(f"vs JAX: {agree}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    out = run(a.quick, a.device)
    report(out)
    agree = jax_agreement(out, a.quick)
    print(f"# vs JAX ({'quick' if a.quick else 'full'}): {agree}")
    failed = failures(out, agree)
    if failed:
        print(f"[pt_whatif] FAILED: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
