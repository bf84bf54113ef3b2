"""Mitigation lab on the port, as ``benchmarks/mitigation_lab.py`` runs it
on the JAX package: search the CC / load-balancing space across a
multi-scenario panel and report the Pareto frontier and the winner.

Every candidate rides the cell axis of one batched run (one launch of
kernel 1 a step for the whole panel). The quick run holds
``benchmarks/mitigation_lab.py``'s three claims at their limits:

* NSLB flat-lines the Fig. 4 leaf-spine cell while ECMP collapses
  (ratio > 0.9 against < 0.85), one geometry with the routing policy as
  data;
* a searched CC config beats the fabric default on a bursty cell by more
  than 0.02 ratio without a baseline cost above 2%;
* the AI-ECN upgrade candidate halves the CE8850 sawtooth's goodput CV
  (the Fig. 3 path);

and each candidate's worst-cell ratio within ``RATIO_REL`` of the JAX
package's, with the same winner (``jax_reference.json
["mitigation_quick"]`` or ``["mitigation_full"]``,
``benchmarks/pt_jax_reference.py --only mitigation``); and the agents'
convergence gate of ``benchmarks/whatif_bench.py``: CMA-ES or BO reaches
the bounded-grid target in strictly fewer evaluations than random
search. ``--grad`` adds
the gradient tier, which runs the step core's plain version
(``core="plain"``; kernel 1 has no gradient). A failed check raises.

``PYTHONPATH=src python -m benchmarks.pt_mitigation_lab [--quick]
[--grad] [--device cpu]``
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

from benchmarks.pt_common import REFERENCE, device_name
from repro_torch.core import bench, congestion as cong
from repro_torch.core.fabric import simulator as sim, systems
from repro_torch.core.fabric.routing import (POLICY_ADAPTIVE, POLICY_ECMP,
                                             POLICY_FLOWLET, POLICY_NSLB)
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.core.mitigation import agents, score, search
from repro_torch.core.mitigation.search import Candidate, PanelCell
from repro_torch.kernels import fabric_step

MiB = float(1 << 20)
# a candidate's worst-cell ratio against JAX's
RATIO_REL = 0.02
# the CE9855-style firmware upgrade for the CE8850: AI-ECN proportional
# marking against an adaptive threshold instead of bang-bang DCQCN
AI_ECN_UPGRADE = Candidate(
    cc=(("kind", 3), ("thresh_adapt", 1.0), ("md", 0.85),
        ("rai_frac", 0.05), ("kmin", 0.1), ("kmax", 0.7)),
    name="ai_ecn_upgrade")
# the agents' race (benchmarks/whatif_bench.py): knobs and quick budget
AGENT_KNOBS = ("hol_factor", "md")
AGENT_BUDGET, AGENT_BATCH = 24, 8
AGENT_KW = dict(n_iters=5, warmup=2, max_steps=60_000)


def candidate_space(quick: bool) -> List[Candidate]:
    """Grid tier: routing policies x CC configs (bounded knobs)."""
    routing = search.RoutingSpace(
        policies=(None, POLICY_ECMP, POLICY_NSLB, POLICY_ADAPTIVE,
                  POLICY_FLOWLET),
        flowlet_gaps_s=(100e-6,) if quick else (50e-6, 200e-6))
    cands = [Candidate(policy=r["policy"], flowlet_gap_s=r["flowlet_gap_s"])
             for r in routing.grid() if r["policy"] is not None]
    cc_space = search.CCSpace.of(
        hol_factor=(0.45, 0.9), md=(0.85,), rai_frac=(0.05,)) if quick \
        else search.CCSpace.of(md=(0.5, 0.85), rai_frac=(0.02, 0.05),
                               kmin=(0.15, 0.3), hol_factor=(0.45, 0.9))
    cands += [Candidate(cc=tuple(sorted(c.items())))
              for c in cc_space.grid()]
    cands.append(AI_ECN_UPGRADE)
    return cands


def score_kw(quick: bool) -> dict:
    return dict(n_iters=10 if quick else 15, warmup=2 if quick else 3,
                max_steps=120_000 if quick else 200_000)


def print_table(scores: List[score.CandidateScore]) -> None:
    print(f"{'candidate':>38} {'ratio_min':>9} {'ratio_mean':>10} "
          f"{'aggr Gb/s':>9} {'jain':>6} {'base_rel':>8}")
    for s in sorted(scores, key=lambda s: -s.ratio_min):
        print(f"{s.candidate:>38} {s.ratio_min:>9.3f} {s.ratio_mean:>10.3f} "
              f"{s.aggr_gbps:>9.1f} {s.jain:>6.3f} "
              f"{s.t_base_worst_rel:>8.3f}")


def _cell_ratio(runs, cell_substr: str, cand: str) -> float:
    vals = [r.ratio for r in runs
            if cell_substr in r.cell and r.candidate == cand]
    return min(vals) if vals else float("nan")


def claims(scores, runs, device) -> Dict:
    """``benchmarks/mitigation_lab.py``'s three claims, with their
    numbers."""
    r_nslb = _cell_ratio(runs, "nanjing", "nslb")
    r_ecmp = _cell_ratio(runs, "nanjing", "ecmp")
    default = next(s for s in scores if s.candidate == "default")
    bursty_cells = {r.cell for r in default.cells if "bursty" in r.cell}
    best_cc, best_gain, best_cell = None, 0.0, None
    for s in scores:
        # CC-axis candidates keep the fabric's native routing
        if not (s.candidate.startswith("native|")
                or s.candidate == AI_ECN_UPGRADE.name):
            continue
        if s.t_base_worst_rel > 1.02:
            continue
        for cell in sorted(bursty_cells):
            gain = _cell_ratio(runs, cell, s.candidate) \
                - _cell_ratio(runs, cell, "default")
            if gain > best_gain:
                best_cc, best_gain, best_cell = s.candidate, gain, cell
    cv_default, cv_tuned = search.sawtooth_cvs(
        "haicgu_ce8850", 4, "ring_allgather", 64 << 20,
        [search.default_candidate(), AI_ECN_UPGRADE], device=device)
    return {"nslb": r_nslb, "ecmp": r_ecmp,
            "ok_fig4": r_nslb > 0.9 and r_ecmp < 0.85,
            "best_cc": best_cc, "best_gain": best_gain,
            "best_cell": best_cell,
            "ok_cc": best_cc is not None and best_gain > 0.02,
            "cv_default": cv_default, "cv_tuned": cv_tuned,
            "ok_saw": cv_tuned < 0.5 * cv_default}


def jax_agreement(scores, winner: str, front: List[str], quick: bool = True,
                  reference: str = REFERENCE) -> Dict:
    """Each candidate's worst-cell ratio against the JAX package's lab
    (``mitigation_quick``, or ``mitigation_full`` where the JAX CPU path
    finished it), the winner and the frontier."""
    with open(reference) as f:
        doc = json.load(f)
    want = doc.get("mitigation_quick") if quick else \
        (doc.get("mitigation_full") or {}).get("result")
    if not want:
        return {"ok": False, "note": f"no JAX {'quick' if quick else 'full'} "
                                     f"lab in {reference}"}
    got = {s.candidate: s.ratio_min for s in scores}
    worst = 0.0
    missing = []
    for cand, w in want["ratio_min"].items():
        if cand not in got:
            missing.append(cand)
            continue
        worst = max(worst, abs(got[cand] / w - 1))
    return {"ok": not missing and worst <= RATIO_REL
            and winner == want["winner"],
            "worst_ratio_rel": worst, "missing": missing,
            "winner": winner, "jax_winner": want["winner"],
            "same_frontier": sorted(front) == sorted(want["frontier"])}


def lab(quick: bool, device) -> Dict:
    """The grid tier on the mitigation panel, with the three claims."""
    device = resolve_device(device)
    panel = score.panel_from_scenario(quick=quick)
    cands = candidate_space(quick)
    print(f"# mitigation lab: {len(cands) + 1} candidates x {len(panel)} "
          f"panel scenarios (one batch) on {device_name(device)}")
    steps0, launches0 = sim.step_count, fabric_step.launches
    t0 = time.time()
    scores = score.score_table(panel, cands, device=device, **score_kw(quick))
    wall = time.time() - t0
    steps, launches = sim.step_count - steps0, fabric_step.launches - launches0
    runs = [r for s in scores for r in s.cells]
    print_table(scores)
    front = score.pareto_frontier(scores)
    print("\n# Pareto frontier (maximize victim ratio, aggressor goodput, "
          "fairness):")
    for s in front:
        print(f"  {s.candidate}: ratio_min={s.ratio_min:.3f} "
              f"aggr={s.aggr_gbps:.1f}Gb/s jain={s.jain:.3f}")
    winner = score.pick_winner(scores)
    print(f"\n# winner (baseline-guarded): {winner.candidate} "
          f"(ratio_min={winner.ratio_min:.3f})")
    print(f"# panel run: {wall:.1f}s, {steps} engine steps, {launches} "
          f"kernel-1 launches")
    c = claims(scores, runs, device)
    verdict = {True: "REPRODUCED", False: "MISMATCH"}
    print(f"\n# Fig.4 check: NSLB ratio {c['nslb']:.2f} vs ECMP "
          f"{c['ecmp']:.2f} -> {verdict[c['ok_fig4']]}")
    print(f"# CC-search check: {c['best_cc']} beats default by "
          f"+{c['best_gain']:.3f} ratio on {c['best_cell']} -> "
          f"{verdict[c['ok_cc']]}")
    print(f"# sawtooth check: CE8850 goodput CV {c['cv_default']:.3f} -> "
          f"{c['cv_tuned']:.3f} with the AI-ECN upgrade -> "
          f"{verdict[c['ok_saw']]}")
    return {"scores": scores, "front": [s.candidate for s in front],
            "winner": winner.candidate, "claims": c, "wall_s": wall,
            "steps": steps, "launches": launches}


def convergence_panel():
    """The agents' race panel (benchmarks/whatif_bench.py): ECMP
    collisions give the knobs a real objective gradient."""
    return (PanelCell(name="ecmp8", system=systems.get_system("nanjing_ecmp"),
                      n_nodes=8, victim="ring_allgather",
                      aggressor="alltoall", vector_bytes=4 * MiB,
                      profile=cong.steady()),)


def run_convergence(device) -> Dict:
    """CMA-ES or BO must reach the bounded-grid target in strictly fewer
    evaluations than random search, at equal budget."""
    t0 = time.time()
    steps0 = sim.step_count
    rep = agents.compare_agents(["random", "ga", "cmaes", "bo"],
                                convergence_panel(), budget=AGENT_BUDGET,
                                batch=AGENT_BATCH, knobs=AGENT_KNOBS, seed=0,
                                device=device, **AGENT_KW)

    def reached(kind):
        e = rep["agents"][kind]["evals_to_target"]
        return float("inf") if e is None else float(e)

    best = min(reached("cmaes"), reached("bo"))
    ok = best < reached("random")
    print(f"# agents: target {rep['target']['objective']:.4f} "
          f"({rep['target']['label']}); evals to target "
          + ", ".join(f"{k} {rep['agents'][k]['evals_to_target']}"
                      for k in rep["agents"])
          + f" -> {'REPRODUCED' if ok else 'MISMATCH'} "
          f"({time.time() - t0:.1f}s, {sim.step_count - steps0} steps)")
    return {"ok": ok, "target": rep["target"],
            "evals_to_target": {k: d["evals_to_target"]
                                for k, d in rep["agents"].items()},
            "wall_s": time.time() - t0}


def grad_case():
    """The gradient tier's cell: CE8850, 8 nodes, AllGather under steady
    incast at 8 MiB, as ``benchmarks/mitigation_lab.py --grad`` builds it."""
    case = bench.build_case(systems.get_system("haicgu_ce8850"), 8,
                            "ring_allgather", "incast")
    dt = bench.choose_dt(case.topo, case.n_victims, 8 << 20, case.lat())
    return case.geom, case.cell_params(8 << 20, cong.steady(), dt)


def run_grad(steps: int, device, n_steps: int = 800) -> Dict:
    device = resolve_device(device)
    geom, params = grad_case()
    out = search.gradient_refine(geom, params, ["md", "rai_frac", "kmin"],
                                 steps=steps, n_steps=n_steps, device=device)
    print(f"# gradient tier (core='plain', {device_name(device)}): knobs "
          f"{out['knobs']}, objective history "
          f"{[f'{h:.6g}' for h in out['history']]}")
    return out


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None, grad: bool = False) -> List[Dict]:
    device = resolve_device(device)
    t0 = time.time()
    res = lab(quick, device)
    c = res["claims"]
    failed = [k for k in ("ok_fig4", "ok_cc", "ok_saw") if not c[k]]
    agree = jax_agreement(res["scores"], res["winner"], res["front"], quick)
    print(f"# vs JAX ({'quick' if quick else 'full'} lab): {agree}")
    if not agree["ok"]:
        failed.append("jax_agreement")
    if not run_convergence(device)["ok"]:
        failed.append("agents")
    if grad:
        run_grad(4 if quick else 10, device)
    print(f"\n[pt_mitigation_lab] done in {time.time() - t0:.0f}s")
    if failed:
        raise RuntimeError(f"mitigation checks failed: {failed}")
    return [{"system": "panel", "mode": s.candidate, "ratio": s.ratio_min}
            for s in res["scores"]]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--grad", action="store_true",
                   help="run the gradient tier (core='plain')")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    try:
        main(quick=a.quick, device=a.device, grad=a.grad)
    except RuntimeError as e:
        print(f"[pt_mitigation_lab] {e}", file=sys.stderr)
        sys.exit(1)
