"""Batched what-if service: concurrent "tune my fabric" queries answered
in shared engine waves.

A :class:`WhatIfQuery` names a fabric question: system, scale, scenario
panel (victim/aggressor collectives, congestion profiles), a knob
subspace and an evaluation budget. The :class:`WhatIfServer` answers it
with the panel winner and the Pareto frontier.

One query's candidate generation underfills a batched engine run, so the
server coalesces every active query's next generation into ONE
``search.run_candidate_rows`` call a wave: queries stack on the cell
axis, their candidates on the lane axis, padded to the wave's widest row
by repeating the last candidate. Each (cell, candidate) scores bit for
bit as the query alone scores it: lanes are built per (cell, candidate),
a padded cell runs as it runs alone, and kernel 1's sums run in a fixed
order. Mixed-scale queries pad into one geometry bucket of the same call
(bench.bucket_stack).

Two candidate tiers a query:

* ``agent="grid"``: a fixed candidate list (explicit, or the bounded
  ``agents.grid_candidates`` grid over the query's knobs), drained batch
  by batch.
* ``agent in agents.AGENTS``: a search agent proposes each generation and
  observes the scores; the server memoizes a query's scores by candidate
  label, so a re-proposal costs no lanes.

Budget exhaustion returns the best so far (``finish_reason="budget"``);
a drained grid or an agent that proposes only known points three waves
running returns ``"drained"``. ``launch.sweep.whatif_launcher`` (or
``mesh=``) splits each wave's lanes across devices; ``cache_dir`` points
the kernel builds at a directory that a restarted service finds them in
(kernels._build.use_build_dir).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import congestion as cong
from repro_torch.core.fabric.systems import get_system
from repro_torch.core.mitigation import agents as agents_lib
from repro_torch.core.mitigation import score as score_lib
from repro_torch.core.mitigation import search
from repro_torch.core.mitigation.agents import AGENT_KNOBS
from repro_torch.core.mitigation.score import CandidateScore
from repro_torch.core.mitigation.search import Candidate, CellRun, PanelCell


@dataclasses.dataclass(frozen=True)
class WhatIfQuery:
    """One "tune my fabric" question. ``profiles=()`` means a single
    steady-congestion panel cell; each extra profile adds a cell (the
    candidate must win across all of them)."""

    system: str
    n_nodes: int
    victim: str = "ring_allgather"
    aggressor: str = "incast"
    vector_bytes: float = float(2 << 20)
    profiles: Tuple[cong.Profile, ...] = ()
    jobs: tuple = ()
    agent: str = "grid"  # "grid" | agents.AGENTS key
    candidates: Optional[Tuple[Candidate, ...]] = None
    knobs: Tuple[str, ...] = AGENT_KNOBS
    budget: int = 24
    batch: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.agent != "grid" and self.agent not in agents_lib.AGENTS:
            raise KeyError(f"unknown agent {self.agent!r}; choose 'grid' "
                           f"or one of {sorted(agents_lib.AGENTS)}")
        if self.budget < 1:
            raise ValueError("budget must be >= 1")
        if self.batch < 1:
            raise ValueError("batch must be >= 1")
        get_system(self.system)  # fail fast on an unknown fabric


@dataclasses.dataclass
class WhatIfResult:
    """A query's answer: the scalar winner under the baseline-tax guard,
    the Pareto frontier and the whole score table."""

    uid: int
    query: WhatIfQuery
    winner: CandidateScore
    winner_candidate: Optional[Candidate]
    objective: float
    frontier: List[CandidateScore]
    scores: List[CandidateScore]
    evals: int
    finish_reason: str  # "budget" | "drained"
    wall_s: float


@dataclasses.dataclass
class WhatIfStats:
    queries_done: int = 0
    waves: int = 0
    coalesced_calls: int = 0  # run_candidate_rows calls
    lanes: int = 0  # engine lanes run (cells x width x 2)
    evals: int = 0  # fresh candidate evaluations charged to queries
    table_hits: int = 0
    wall_s: float = 0.0


class _QueryState:
    """The server's bookkeeping for one query in flight."""

    def __init__(self, query: WhatIfQuery, uid: int):
        self.query = query
        self.uid = uid
        self.submitted_s = time.monotonic()
        profiles = query.profiles or (cong.steady(),)
        system = get_system(query.system)
        # the uid prefix keeps coalesced cell names apart even when two
        # queries ask about the same scenario
        self.cells = [PanelCell(
            name=(f"q{uid}:{query.system}-{query.n_nodes}"
                  f"/{query.aggressor}/{prof.label()}"
                  f"/{int(query.vector_bytes)}"),
            system=system, n_nodes=query.n_nodes, victim=query.victim,
            aggressor=query.aggressor, vector_bytes=query.vector_bytes,
            profile=prof, jobs=query.jobs) for prof in profiles]
        self.agent: Optional[agents_lib.SearchAgent] = None
        self.pending: Deque[Candidate] = deque()
        if query.agent == "grid":
            cands = query.candidates or tuple(
                agents_lib.grid_candidates(query.knobs))
            self.pending.extend(cands)
        else:
            self.agent = agents_lib.make_agent(
                query.agent, knobs=query.knobs, batch=query.batch,
                seed=query.seed)
        self.cell_runs: List[CellRun] = []
        self._seen_runs: set = set()
        self.cand_by_label: Dict[str, Candidate] = {}
        self.table: Dict[str, CandidateScore] = {}
        self.evals = 0
        self.started = False  # the default candidate rides the first wave
        self.last_props: List[Candidate] = []
        self.stalls = 0

    # ---- wave participation -------------------------------------------
    def next_row(self) -> List[Candidate]:
        """The candidates this query puts into the next wave (fresh points
        only; known labels are served from the memo table)."""
        if self.agent is None:
            props = [self.pending.popleft()
                     for _ in range(min(self.query.batch,
                                        len(self.pending)))]
        else:
            props = list(self.agent.propose(self.agent.history))
        self.last_props = props
        fresh, labels = [], set(self.table)
        for c in props:
            lab = c.label()
            if lab not in labels:
                fresh.append(c)
                labels.add(lab)
        row = list(fresh)
        if not self.started:
            row.insert(0, search.default_candidate())
        return row

    def absorb(self, runs: Sequence[CellRun], n_fresh: int) -> None:
        """Fold a wave's runs of this query into its scores. Padding
        duplicates (the same cell and candidate) are dropped: they are
        bit-identical copies."""
        for r in runs:
            key = (r.cell, r.candidate)
            if key not in self._seen_runs:
                self._seen_runs.add(key)
                self.cell_runs.append(r)
        self.table = {s.candidate: s
                      for s in score_lib.aggregate(self.cell_runs)}
        self.evals += n_fresh
        self.started = True

    def observe(self) -> None:
        if self.agent is None or not self.last_props:
            return
        obs = [agents_lib.Observation(c, agents_lib.objective(
            self.table[c.label()]), self.table[c.label()])
            for c in self.last_props if c.label() in self.table]
        if obs:
            self.agent.observe(obs)

    def finished(self) -> Optional[str]:
        if self.evals >= self.query.budget:
            return "budget"
        if self.agent is None and not self.pending:
            return "drained"
        if self.stalls >= 3:  # the agent proposes known points only
            return "drained"
        return None

    def finalize(self, reason: str) -> WhatIfResult:
        scores = list(self.table.values())
        winner = score_lib.pick_winner(scores)
        return WhatIfResult(
            uid=self.uid, query=self.query, winner=winner,
            winner_candidate=self.cand_by_label.get(winner.candidate),
            objective=agents_lib.objective(winner),
            frontier=score_lib.pareto_frontier(scores), scores=scores,
            evals=self.evals, finish_reason=reason,
            wall_s=time.monotonic() - self.submitted_s)


class WhatIfServer:
    """Wave scheduler over concurrent what-if queries: admit up to
    ``max_batch`` queries, coalesce their next candidate generations into
    one ``run_candidate_rows`` call, and hand each query its result when
    its budget or its candidates run out. Runs on ``device`` (default:
    the CUDA device), or across a ``mesh``'s devices, or through a
    ``launcher`` (launch/sweep.py)."""

    def __init__(self, *, max_batch: int = 4, n_iters: int = 12,
                 warmup: int = 3, max_steps: int = 200_000,
                 chunk: int = 2048, stride: int = 8, device=None, mesh=None,
                 launcher=None, cache_dir: Optional[str] = None):
        if cache_dir:
            from repro_torch.kernels import _build

            _build.use_build_dir(cache_dir)
        self.max_batch = int(max_batch)
        self.run_kw = dict(n_iters=n_iters, warmup=warmup,
                           max_steps=max_steps, chunk=chunk, stride=stride,
                           device=device, mesh=mesh, launcher=launcher)
        self.queue: Deque[_QueryState] = deque()
        self.active: List[_QueryState] = []
        self.results: Dict[int, WhatIfResult] = {}
        self.stats = WhatIfStats()
        self._uid = 0

    # ------------------------------------------------------------------
    def submit(self, query: WhatIfQuery) -> int:
        self._uid += 1
        self.queue.append(_QueryState(query, self._uid))
        return self._uid

    def poll(self, uid: int) -> Optional[WhatIfResult]:
        return self.results.get(uid)

    def result(self, uid: int) -> WhatIfResult:
        if uid not in self.results:
            raise KeyError(f"query {uid} not finished "
                           f"(pending={len(self.queue)}, "
                           f"active={len(self.active)})")
        return self.results[uid]

    # ------------------------------------------------------------------
    def wave_rows(self) -> Tuple[list, List[PanelCell], List[list]]:
        """Admit queries and build the next wave: ``(plans, cells,
        rows)``, ``plans`` a ``(state, row, n_fresh)`` per query that
        sends candidates, ``cells`` and ``rows`` what
        ``run_candidate_rows`` runs (empty when no query sends any).
        Queries whose proposals are all known count a stall instead."""
        while self.queue and len(self.active) < self.max_batch:
            self.active.append(self.queue.popleft())
        plans = []
        for st in self.active:
            row = st.next_row()
            for c in row:
                st.cand_by_label.setdefault(c.label(), c)
            n_fresh = len(row) - (0 if st.started else 1)
            if row:
                plans.append((st, row, n_fresh))
            else:
                # every proposal was already scored: the agent observes
                # from the memo table without costing lanes
                self.stats.table_hits += len(st.last_props)
                st.stalls += 1
        cells: List[PanelCell] = []
        rows: List[list] = []
        if plans:
            width = max(len(row) for _, row, _ in plans)
            for st, row, _ in plans:
                padded = row + [row[-1]] * (width - len(row))
                cells.extend(st.cells)
                rows.extend([padded] * len(st.cells))
        return plans, cells, rows

    def step_wave(self) -> int:
        """Admit queries, run one coalesced wave, retire finished queries.
        Returns the number of queries that made progress."""
        if not self.queue and not self.active:
            return 0
        t0 = time.monotonic()
        plans, cells, rows = self.wave_rows()
        if plans:
            runs = search.run_candidate_rows(cells, rows, **self.run_kw)
            self.stats.coalesced_calls += 1
            self.stats.lanes += 2 * len(rows[0]) * len(cells)
            by_query: Dict[int, List[CellRun]] = {}
            for r in runs:
                uid = int(r.cell.split(":", 1)[0][1:])
                by_query.setdefault(uid, []).append(r)
            for st, row, n_fresh in plans:
                st.absorb(by_query.get(st.uid, []), n_fresh)
                st.stalls = 0
                self.stats.evals += n_fresh

        progressed = 0
        still_active: List[_QueryState] = []
        for st in self.active:
            st.observe()
            reason = st.finished()
            if reason is not None:
                self.results[st.uid] = st.finalize(reason)
                self.stats.queries_done += 1
            else:
                still_active.append(st)
            progressed += 1
        self.active = still_active
        self.stats.waves += 1
        self.stats.wall_s += time.monotonic() - t0
        return progressed

    def run_until_drained(self, max_waves: int = 200) -> WhatIfStats:
        for _ in range(max_waves):
            if not self.queue and not self.active:
                break
            self.step_wave()
        return self.stats
