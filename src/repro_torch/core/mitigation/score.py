"""Multi-scenario Pareto scoring for mitigation candidates.

Each candidate is measured across a *panel* of scenarios drawn from the
scenario registry (steady incast, bursty duty cycles, multi-job mixes)
and summarized on three axes:

* ``ratio_min`` / ``ratio_mean`` — victim slowdown (the paper's
  t_uncongested/t_congested; 1.0 = congestion fully mitigated). The
  worst cell is the headline: a mitigation that flat-lines steady incast
  but collapses under bursts has NOT solved the problem.
* ``aggr_gbps`` — aggressor/background goodput. Throttling aggressors to
  zero trivially protects victims (Olmedilla et al.'s injection-
  throttling tradeoff); a real mitigation keeps background tenants fed.
* ``jain`` — Jain fairness over victim flows' delivered bytes (a policy
  that saves the mean by starving one victim flow shows up here).

:func:`pareto_frontier` reports the non-dominated candidates on those
axes; :func:`pick_winner` scalarizes (worst-cell ratio first, then
fairness, then aggressor goodput) under a baseline guard: a winner may
not degrade the uncongested iteration time vs the fabric default by
more than ``baseline_slack``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import scenarios as scen
from repro_torch.core.fabric import systems
from repro_torch.core.mitigation import search
from repro_torch.core.mitigation.search import Candidate, CellRun, PanelCell

# scenario families the default panel draws from
PANEL_SCENARIO = "mitigation_panel"
# the link-fault robustness panel: benchmarks/pt_fault_scenarios.py asks
# "which CC/routing config is robust to a flapping link" per fabric
FAULT_PANEL_SCENARIO = "link_fault"


def panel_from_scenario(name: str = PANEL_SCENARIO,
                        quick: bool = False) -> List[PanelCell]:
    """Expand a registered grid scenario into panel cells, one per (grid,
    cell, size, profile): the registry stays the one source of scenario
    truth; the panel is a flattened view of it."""
    scenario = scen.get(name, quick)
    cells: List[PanelCell] = []
    for grid in scenario.grids:
        # scale-batched grids carry (system, n_nodes) in ``cells`` and a
        # placeholder label in ``system``; plain grids are the one-cell
        # special case
        grid_cells = list(grid.cells) or [(grid.system, grid.n_nodes)]
        for sysname, n in grid_cells:
            sysp = systems.get_system(sysname)
            for v in grid.sizes:
                for prof in grid.profiles:
                    # n_nodes is part of the key: scale-batched grids
                    # repeat a system at several scales, and aggregate()
                    # matches baselines by cell name
                    cells.append(PanelCell(
                        name=f"{name}:{sysname}-{int(n)}/{grid.aggressor}"
                             f"/{prof.label()}/{int(v)}",
                        system=sysp, n_nodes=int(n), victim=grid.victim,
                        aggressor=grid.aggressor, vector_bytes=float(v),
                        profile=prof, jobs=tuple(grid.jobs)))
    return cells


@dataclasses.dataclass
class CandidateScore:
    """Panel-aggregated scorecard of one candidate."""

    candidate: str
    ratio_min: float  # worst-cell victim ratio (headline axis)
    ratio_mean: float
    aggr_gbps: float  # mean aggressor/background goodput, congested lanes
    jain: float  # mean victim fairness
    t_base_worst_rel: float  # worst baseline time relative to default (1.0 =
    # no uncongested-cost; >1 = the mitigation taxes the uncongested case)
    cells: Tuple[CellRun, ...] = ()
    # panel cells this candidate did not finish (zero completed
    # iterations): excluded from every axis above; a candidate that DNFs
    # its WHOLE panel has NaN axes and is dropped from the frontier
    n_dnf: int = 0


def aggregate(runs: Sequence[CellRun],
              default_label: str = "default") -> List[CandidateScore]:
    """Fold per-cell runs into per-candidate scorecards. Baseline cost is
    measured against the ``default_label`` candidate's uncongested time
    on the same cell (the fabric's shipped config). DNF cells (zero
    completed iterations — NaN times) are counted in ``n_dnf`` and
    excluded from the axes rather than silently averaged."""
    by_cand: Dict[str, List[CellRun]] = {}
    for r in runs:
        by_cand.setdefault(r.candidate, []).append(r)
    base_t = {r.cell: r.t_uncongested_s
              for r in by_cand.get(default_label, []) if not r.dnf}
    out = []
    for cand, rs in by_cand.items():
        ok = [r for r in rs if not r.dnf]
        rel = [r.t_uncongested_s / base_t[r.cell]
               for r in ok if base_t.get(r.cell, 0) > 0]
        out.append(CandidateScore(
            candidate=cand,
            ratio_min=min(r.ratio for r in ok) if ok else float("nan"),
            ratio_mean=float(np.mean([r.ratio for r in ok]))
            if ok else float("nan"),
            aggr_gbps=float(np.mean(
                [8e-9 * r.aggr_bytes / max(r.sim_time_s, 1e-9)
                 for r in ok])) if ok else float("nan"),
            jain=float(np.mean([r.jain for r in ok]))
            if ok else float("nan"),
            t_base_worst_rel=max(rel) if rel else 1.0,
            cells=tuple(rs),
            n_dnf=len(rs) - len(ok)))
    return out


# Pareto axes: all maximized
AXES = ("ratio_min", "aggr_gbps", "jain")


def _dominates(a: CandidateScore, b: CandidateScore, eps: float) -> bool:
    ge = all(getattr(a, ax) >= getattr(b, ax) - eps for ax in AXES)
    gt = any(getattr(a, ax) > getattr(b, ax) + eps for ax in AXES)
    return ge and gt


def _scored(scores: Sequence[CandidateScore]) -> List[CandidateScore]:
    """Candidates with at least one finished panel cell (full-panel DNF
    leaves every axis NaN — incomparable, excluded from the frontier)."""
    return [s for s in scores if np.isfinite(s.ratio_min)]


def pareto_frontier(scores: Sequence[CandidateScore],
                    eps: float = 1e-3) -> List[CandidateScore]:
    """Non-dominated candidates on (victim ratio, aggressor goodput,
    fairness), sorted by worst-cell ratio descending. Full-panel DNF
    candidates are excluded (their axes are NaN)."""
    scores = _scored(scores)
    front = [s for s in scores
             if not any(_dominates(o, s, eps) for o in scores if o is not s)]
    return sorted(front, key=lambda s: (-s.ratio_min, -s.jain,
                                        -s.aggr_gbps))


def pick_winner(scores: Sequence[CandidateScore],
                baseline_slack: float = 0.02) -> CandidateScore:
    """Scalarized per-fabric winner: best worst-cell ratio (then
    fairness, then aggressor goodput) among candidates whose uncongested
    baseline stays within ``baseline_slack`` of the fabric default.
    Full-panel DNF candidates never win (unless EVERY candidate DNF'd,
    in which case the first is returned as a flagged placeholder)."""
    finished = _scored(scores)
    if not finished:  # nothing completed: surface the failure, don't crash
        return scores[0]
    ok = [s for s in finished if s.t_base_worst_rel <= 1.0 + baseline_slack]
    if not ok:  # every candidate taxes the baseline; fall back to all
        ok = finished
    return max(ok, key=lambda s: (round(s.ratio_min, 3),
                                  round(s.jain, 3), s.aggr_gbps))


def winners_by_system(runs: Sequence[CellRun],
                      baseline_slack: float = 0.02,
                      default_label: str = "default",
                      ) -> Dict[str, CandidateScore]:
    """Per-fabric winners: split cell runs on the system token of the
    panel-cell name (``<scenario>:<system>-<n>/...``, the format
    :func:`panel_from_scenario` emits) and pick a winner per fabric.
    The fault panels care about this split — a config that rescues a
    flapping Slingshot link may tax a fat-tree's baseline."""
    by_sys: Dict[str, List[CellRun]] = {}
    for r in runs:
        sysname = r.cell.split(":", 1)[-1].split("-", 1)[0]
        by_sys.setdefault(sysname, []).append(r)
    return {s: pick_winner(aggregate(rs, default_label=default_label),
                           baseline_slack=baseline_slack)
            for s, rs in sorted(by_sys.items())}


def score_table(panel: Sequence[PanelCell],
                candidates: Sequence[Candidate], *, n_iters: int = 12,
                warmup: int = 3, **kw) -> List[CandidateScore]:
    """Run the full (panel x candidate) sweep as one batch and aggregate
    (``kw`` goes to :func:`search.run_candidates`: ``device``, the step
    budget). The default candidate is prepended if absent so
    baseline guards always have a reference."""
    cands = list(candidates)
    if not any(c.label() == "default" for c in cands):
        cands.insert(0, search.default_candidate())
    runs = search.run_candidates(panel, cands, n_iters=n_iters,
                                 warmup=warmup, **kw)
    return aggregate(runs)
