"""Pluggable mitigation-search agents over the batched evaluator
(archgym-style simulator-backed design-space search).

A :class:`SearchAgent` proposes a *batch* of :class:`Candidate` points
per generation and observes their panel scores:

    propose(history) -> List[Candidate]     # one generation
    observe(observations)                   # scores come back

Agents search the normalized unit cube over a set of continuous CC
knobs (``cc.SEARCH_BOUNDS``); :class:`PanelEvaluator` lowers every
generation into ONE ``search.run_candidates`` call: the candidates ride
the cell axis, so a generation is one ``run_cells_hetero`` batch. The
evaluator memoizes scores by candidate label, so an agent re-proposing
an already-scored point hits the table instead of the simulator.

Four implementations (the archgym lineup, numpy-only):

* :class:`RandomWalkAgent` — uniform random search, the baseline every
  learned agent must beat.
* :class:`GAAgent` — (mu + lambda) evolutionary search: tournament
  selection, blend crossover, gaussian mutation.
* :class:`CMAESAgent` — separable (diagonal-covariance) CMA-ES with
  step-size adaptation via the standard evolution paths.
* :class:`BOAgent` — lightweight Bayesian optimization: a Matern-5/2 GP
  surrogate fit by Cholesky, expected-improvement acquisition maximized
  over a seeded random pool.

:func:`run_agent` drives one agent to an evaluation budget and logs a
:class:`Trajectory` (best-so-far score vs. evaluations, wall-clock,
engine steps); :func:`compare_agents` produces the archgym-style
time-to-convergence report against the bounded-grid winner
(:func:`grid_reference`).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.cc import SEARCH_BOUNDS
from repro_torch.core.mitigation import score as score_lib
from repro_torch.core.mitigation import search
from repro_torch.core.mitigation.score import CandidateScore
from repro_torch.core.mitigation.search import Candidate, PanelCell

# default knob subset agents navigate: the injection-throttling axes of
# Olmedilla et al. (DCQCN/AI-ECN rate control + HOL isolation)
AGENT_KNOBS = ("hol_factor", "md", "rai_frac")

# baseline-tax penalty: pick_winner disqualifies candidates whose
# uncongested baseline exceeds the default by > 2%; the scalar objective
# soft-penalizes past the same slack so the search landscape stays
# continuous while agreeing with the winner guard at the optimum
BASELINE_SLACK = 0.02
TAX_WEIGHT = 10.0


def objective(s: CandidateScore) -> float:
    """Scalarized panel score (maximized): worst-cell victim ratio,
    soft-penalized by any uncongested-baseline tax beyond the
    ``pick_winner`` slack. Full-panel DNF is -inf."""
    if not np.isfinite(s.ratio_min):
        return float("-inf")
    tax = max(0.0, s.t_base_worst_rel - (1.0 + BASELINE_SLACK))
    return float(s.ratio_min - TAX_WEIGHT * tax)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One scored candidate handed back to the agent."""

    candidate: Candidate
    objective: float
    score: CandidateScore


# --------------------------------------------------------------------------
# Batched panel evaluation with a memo table
# --------------------------------------------------------------------------


class PanelEvaluator:
    """Scores candidate batches on a fixed panel through ONE
    ``run_candidates`` call per batch, memoizing by candidate label.

    The fabric-default candidate rides the first fresh batch (aggregate
    needs its uncongested times as the baseline reference).
    ``evals`` counts candidate evaluations actually sent to the
    simulator (the default baseline is shared overhead, not charged);
    ``table_hits`` counts re-proposals served from the memo.
    ``mesh``/``launcher`` split each batch's candidate lanes across
    devices (launch/sweep.py)."""

    def __init__(self, panel: Sequence[PanelCell], *, n_iters: int = 12,
                 warmup: int = 3, max_steps: int = 200_000,
                 chunk: int = 2048, stride: int = 8, device=None,
                 mesh=None, launcher=None):
        self.panel = list(panel)
        self.kw = dict(n_iters=n_iters, warmup=warmup, max_steps=max_steps,
                       chunk=chunk, stride=stride, device=device, mesh=mesh,
                       launcher=launcher)
        self.table: Dict[str, CandidateScore] = {}
        self._default_runs: Optional[list] = None
        self.evals = 0
        self.table_hits = 0
        self.calls = 0

    def evaluate(self, cands: Sequence[Candidate]) -> List[CandidateScore]:
        return evaluate_together([(self, cands)])[0]

    def _fresh(self, cands: Sequence[Candidate]) -> List[Candidate]:
        """The candidates of ``cands`` to send to the simulator (the
        default first, on the first fresh batch); counts table hits."""
        fresh: List[Candidate] = []
        seen = set(self.table)
        for c in cands:
            lab = c.label()
            if lab in seen:
                self.table_hits += 1
            else:
                fresh.append(c)
                seen.add(lab)
        if fresh and self._default_runs is None:
            fresh.insert(0, search.default_candidate())
        return fresh

    def _absorb(self, batch: Sequence[Candidate], runs: list) -> None:
        """Score the runs of ``batch`` (from :meth:`_fresh`) into the
        table."""
        if self._default_runs is None:
            self._default_runs = [r for r in runs
                                  if r.candidate == "default"]
            self.evals += len(batch) - 1
        else:
            runs = runs + self._default_runs
            self.evals += len(batch)
        self.calls += 1
        for s in score_lib.aggregate(runs):
            self.table[s.candidate] = s


def evaluate_together(pairs) -> List[List[CandidateScore]]:
    """Score several evaluators' candidate batches, ``[(evaluator,
    candidates), ...]``, in ONE ``run_candidates`` call when they share a
    panel and engine settings: each evaluator's fresh candidates ride the
    cell axis beside the others', and each keeps its own memo and
    counts. A cell's result does not depend on the batch around it, so
    the scores are those of one call per evaluator."""
    evs = [ev for ev, _ in pairs]
    if any(ev.panel != evs[0].panel or ev.kw != evs[0].kw for ev in evs):
        raise ValueError("evaluators scored together need one panel and "
                         "one set of engine settings")
    batches = [ev._fresh(cands) for ev, cands in pairs]
    flat = [c for b in batches for c in b]
    if flat:
        runs = search.run_candidates(evs[0].panel, flat, **evs[0].kw)
        K = len(flat)  # runs are cell-major, then candidate
        lo = 0
        for ev, b in zip(evs, batches):
            if b:
                ev._absorb(b, [r for i, r in enumerate(runs)
                               if lo <= i % K < lo + len(b)])
            lo += len(b)
    return [[ev.table[c.label()] for c in cands] for ev, cands in pairs]


# --------------------------------------------------------------------------
# Agent interface + the four implementations
# --------------------------------------------------------------------------


class SearchAgent:
    """Base: candidates <-> normalized unit-cube vectors over a set of
    continuous ``SEARCH_BOUNDS`` knobs. Deterministic under a fixed seed
    (every draw comes from the agent's own ``default_rng``)."""

    kind = "agent"

    def __init__(self, knobs: Sequence[str] = AGENT_KNOBS, *,
                 batch: int = 8, seed: int = 0,
                 policy: Optional[int] = None):
        knobs = tuple(knobs)
        for k in knobs:
            if k not in search.GRAD_KNOBS:
                raise KeyError(f"{k!r} is not a continuous searchable "
                               f"knob; choose from {search.GRAD_KNOBS}")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.knobs = knobs
        self.dim = len(knobs)
        self.bounds = np.asarray([SEARCH_BOUNDS[k] for k in knobs],
                                 np.float64)
        self.batch = int(batch)
        self.seed = int(seed)
        self.rng = np.random.default_rng(seed)
        self.policy = policy
        self.history: List[Observation] = []

    # ---- unit cube <-> Candidate --------------------------------------
    def to_candidate(self, x: np.ndarray) -> Candidate:
        x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        vals = lo + (hi - lo) * x
        return Candidate(policy=self.policy,
                         cc=tuple(sorted(zip(self.knobs, map(float, vals)))))

    def to_vector(self, cand: Candidate) -> np.ndarray:
        cc = dict(cand.cc)
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        vals = np.asarray([cc[k] for k in self.knobs], np.float64)
        return np.clip((vals - lo) / (hi - lo), 0.0, 1.0)

    # ---- the pluggable surface ----------------------------------------
    def propose(self, history: Sequence[Observation]) -> List[Candidate]:
        raise NotImplementedError

    def observe(self, observations: Sequence[Observation]) -> None:
        self.history.extend(observations)
        self._update(list(observations))

    def _update(self, obs: List[Observation]) -> None:
        pass

    # ---- helpers -------------------------------------------------------
    def _finite(self, f: float) -> float:
        # DNF lanes rank strictly below every finished candidate but
        # stay finite so means/weights remain well-defined
        return f if np.isfinite(f) else -1e6

    def best(self) -> Optional[Observation]:
        if not self.history:
            return None
        return max(self.history, key=lambda o: self._finite(o.objective))


class RandomWalkAgent(SearchAgent):
    """Uniform random search — the archgym random-walker baseline every
    learned agent is compared against at equal budget."""

    kind = "random"

    def propose(self, history) -> List[Candidate]:
        return [self.to_candidate(self.rng.uniform(size=self.dim))
                for _ in range(self.batch)]


class GAAgent(SearchAgent):
    """(mu + lambda) evolutionary search: tournament selection over the
    surviving population, per-dimension blend crossover, gaussian
    mutation."""

    kind = "ga"

    def __init__(self, knobs: Sequence[str] = AGENT_KNOBS, *,
                 batch: int = 8, seed: int = 0,
                 policy: Optional[int] = None, mu: int = 8,
                 sigma: float = 0.12, p_mut: float = 0.5):
        super().__init__(knobs, batch=batch, seed=seed, policy=policy)
        self.mu = int(mu)
        self.sigma = float(sigma)
        self.p_mut = float(p_mut)
        self.pop: List[Tuple[np.ndarray, float]] = []

    def _tournament(self) -> np.ndarray:
        k = min(3, len(self.pop))
        picks = [self.pop[i] for i in
                 self.rng.choice(len(self.pop), size=k, replace=False)]
        return max(picks, key=lambda p: p[1])[0]

    def propose(self, history) -> List[Candidate]:
        if not self.pop:  # seed generation
            return [self.to_candidate(self.rng.uniform(size=self.dim))
                    for _ in range(self.batch)]
        out = []
        for _ in range(self.batch):
            pa, pb = self._tournament(), self._tournament()
            alpha = self.rng.uniform(size=self.dim)
            child = alpha * pa + (1.0 - alpha) * pb
            mut = self.rng.random(self.dim) < self.p_mut
            child = child + mut * self.rng.normal(0.0, self.sigma, self.dim)
            out.append(self.to_candidate(child))
        return out

    def _update(self, obs: List[Observation]) -> None:
        self.pop.extend((self.to_vector(o.candidate),
                         self._finite(o.objective)) for o in obs)
        self.pop.sort(key=lambda p: -p[1])
        del self.pop[self.mu:]


class CMAESAgent(SearchAgent):
    """Separable CMA-ES (diagonal covariance): rank-weighted mean
    recombination, cumulative step-size adaptation, and per-dimension
    variance updates — the standard sep-CMA-ES constants, numpy-only."""

    kind = "cmaes"

    def __init__(self, knobs: Sequence[str] = AGENT_KNOBS, *,
                 batch: int = 8, seed: int = 0,
                 policy: Optional[int] = None, sigma0: float = 0.3):
        super().__init__(knobs, batch=batch, seed=seed, policy=policy)
        d, lam = self.dim, self.batch
        self.mean = np.full(d, 0.5)
        self.sigma = float(sigma0)
        mu = max(lam // 2, 1)
        w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
        self.w = w / w.sum()
        self.mueff = 1.0 / np.sum(self.w ** 2)
        self.cs = (self.mueff + 2.0) / (d + self.mueff + 5.0)
        self.damps = 1.0 + 2.0 * max(
            0.0, math.sqrt((self.mueff - 1.0) / (d + 1.0)) - 1.0) + self.cs
        self.cc = (4.0 + self.mueff / d) / (d + 4.0 + 2.0 * self.mueff / d)
        self.c1 = 2.0 / ((d + 1.3) ** 2 + self.mueff)
        self.cmu = min(1.0 - self.c1,
                       2.0 * (self.mueff - 2.0 + 1.0 / self.mueff)
                       / ((d + 2.0) ** 2 + self.mueff))
        # sep-CMA corrections scale cmu up for diagonal-only updates
        self.cmu = min(1.0 - self.c1, self.cmu * (d + 2.0) / 3.0)
        self.C = np.ones(d)
        self.ps = np.zeros(d)
        self.pc = np.zeros(d)
        self.chiN = math.sqrt(d) * (1.0 - 1.0 / (4.0 * d)
                                    + 1.0 / (21.0 * d * d))
        self.gen = 0
        self._last: List[np.ndarray] = []

    def propose(self, history) -> List[Candidate]:
        std = self.sigma * np.sqrt(self.C)
        self._last = [np.clip(self.mean + std
                              * self.rng.standard_normal(self.dim), 0.0, 1.0)
                      for _ in range(self.batch)]
        return [self.to_candidate(x) for x in self._last]

    def _update(self, obs: List[Observation]) -> None:
        # re-derive the sampled vectors from the observed candidates so
        # table-served duplicates cannot desynchronize sampling state
        xs = np.asarray([self.to_vector(o.candidate) for o in obs])
        fs = np.asarray([self._finite(o.objective) for o in obs])
        order = np.argsort(-fs)
        mu = len(self.w)
        if len(order) < mu:  # short generation (budget tail)
            w = self.w[:len(order)]
            w = w / w.sum()
        else:
            w = self.w
        sel = xs[order[:len(w)]]
        old = self.mean
        self.mean = w @ sel
        d = self.dim
        y = (self.mean - old) / max(self.sigma, 1e-12)
        self.ps = (1.0 - self.cs) * self.ps + math.sqrt(
            self.cs * (2.0 - self.cs) * self.mueff) \
            * y / np.sqrt(np.maximum(self.C, 1e-12))
        self.gen += 1
        hsig = (np.linalg.norm(self.ps)
                / math.sqrt(1.0 - (1.0 - self.cs) ** (2.0 * self.gen))
                / self.chiN) < 1.4 + 2.0 / (d + 1.0)
        self.pc = (1.0 - self.cc) * self.pc + hsig * math.sqrt(
            self.cc * (2.0 - self.cc) * self.mueff) * y
        artmp = (sel - old) / max(self.sigma, 1e-12)
        self.C = (1.0 - self.c1 - self.cmu) * self.C \
            + self.c1 * (self.pc ** 2
                         + (1.0 - hsig) * self.cc * (2.0 - self.cc) * self.C) \
            + self.cmu * (w @ (artmp ** 2))
        self.C = np.maximum(self.C, 1e-8)
        self.sigma *= math.exp((self.cs / self.damps)
                               * (np.linalg.norm(self.ps) / self.chiN - 1.0))
        self.sigma = float(np.clip(self.sigma, 1e-4, 1.0))


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


class BOAgent(SearchAgent):
    """Lightweight Bayesian optimization: Matern-5/2 GP surrogate (fixed
    lengthscale, Cholesky fit with jitter) + expected-improvement
    acquisition maximized over a seeded random pool mixed with local
    perturbations of the incumbent. Pure numpy — no scipy."""

    kind = "bo"

    def __init__(self, knobs: Sequence[str] = AGENT_KNOBS, *,
                 batch: int = 8, seed: int = 0,
                 policy: Optional[int] = None, lengthscale: float = 0.25,
                 noise: float = 1e-4, pool: int = 256, xi: float = 0.01):
        super().__init__(knobs, batch=batch, seed=seed, policy=policy)
        self.ell = float(lengthscale)
        self.noise = float(noise)
        self.pool = int(pool)
        self.xi = float(xi)

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d = np.sqrt(np.maximum(
            ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1), 1e-18))
        r = math.sqrt(5.0) * d / self.ell
        return (1.0 + r + r * r / 3.0) * np.exp(-r)

    def propose(self, history) -> List[Candidate]:
        obs = [o for o in history if np.isfinite(o.objective)]
        if len(obs) < max(2 * self.dim, 4):  # cold start: space-filling
            return [self.to_candidate(self.rng.uniform(size=self.dim))
                    for _ in range(self.batch)]
        X = np.asarray([self.to_vector(o.candidate) for o in obs])
        y = np.asarray([o.objective for o in obs], np.float64)
        ym, ys = y.mean(), max(y.std(), 1e-9)
        yn = (y - ym) / ys
        K = self._kernel(X, X) + (self.noise + 1e-8) * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        # acquisition pool: global uniform + local moves around the best
        best_x = X[int(np.argmax(y))]
        cand = np.concatenate([
            self.rng.uniform(size=(self.pool, self.dim)),
            np.clip(best_x + 0.1
                    * self.rng.standard_normal((self.pool // 4, self.dim)),
                    0.0, 1.0)])
        Ks = self._kernel(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-12)
        sd = np.sqrt(var)
        f_best = yn.max()
        z = (mu - f_best - self.xi) / sd
        ei = (mu - f_best - self.xi) * _norm_cdf(z) + sd * _norm_pdf(z)
        order = np.argsort(-ei)
        picks: List[np.ndarray] = []
        for i in order:
            x = cand[i]
            if any(np.abs(x - p).max() < 1e-3 for p in picks):
                continue  # batch-diversity: skip near-duplicates
            picks.append(x)
            if len(picks) == self.batch:
                break
        while len(picks) < self.batch:  # pool exhausted: explore
            picks.append(self.rng.uniform(size=self.dim))
        return [self.to_candidate(x) for x in picks]


AGENTS = {a.kind: a for a in (RandomWalkAgent, GAAgent, CMAESAgent, BOAgent)}


def make_agent(kind: str, **kw) -> SearchAgent:
    if kind not in AGENTS:
        raise KeyError(f"unknown agent kind {kind!r}; "
                       f"known: {sorted(AGENTS)}")
    return AGENTS[kind](**kw)


# --------------------------------------------------------------------------
# Trajectory logging + the archgym-style comparison harness
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Trajectory:
    """Per-agent search log: best-so-far objective vs. cumulative
    simulator evaluations, wall-clock and engine steps after each
    generation."""

    agent: str
    evals: List[int] = dataclasses.field(default_factory=list)
    best: List[float] = dataclasses.field(default_factory=list)
    wall_s: List[float] = dataclasses.field(default_factory=list)
    steps: List[int] = dataclasses.field(default_factory=list)
    best_label: str = ""
    best_score: Optional[CandidateScore] = None

    def evals_to(self, target: float, tol: float = 1e-6) -> Optional[int]:
        """Evaluations spent when best-so-far first reached ``target``
        (None = never within budget) — the time-to-convergence axis."""
        for e, b in zip(self.evals, self.best):
            if b >= target - tol:
                return e
        return None

    def as_dict(self) -> dict:
        return {"agent": self.agent, "evals": list(self.evals),
                "best": [float(b) for b in self.best],
                "wall_s": [round(float(w), 3) for w in self.wall_s],
                "steps": list(self.steps),
                "best_label": self.best_label,
                "best_objective": float(self.best[-1])
                if self.best else float("-inf")}


def run_agent(agent: SearchAgent, panel: Sequence[PanelCell], *,
              budget: int = 32,
              evaluator: Optional[PanelEvaluator] = None,
              **run_kw) -> Trajectory:
    """Drive one agent to ``budget`` simulator evaluations; one
    ``run_candidates`` call per generation. Budgets that are a multiple
    of the agent's batch land exactly; otherwise the final generation
    overruns by at most batch-1 (generations keep one size)."""
    ev = evaluator if evaluator is not None else PanelEvaluator(
        panel, **run_kw)
    return run_agents([agent], [ev], budget=budget)[0]


def run_agents(agents_: Sequence[SearchAgent],
               evaluators: Sequence[PanelEvaluator], *,
               budget: int = 32) -> List[Trajectory]:
    """Drive several agents, each with its own evaluator, to ``budget``
    evaluations in lock step: generation g of every agent still running
    is scored in one ``run_candidates`` call (:func:`evaluate_together`).
    Each agent draws, observes and stops as it would alone, so each
    trajectory's evaluations and scores are those of :func:`run_agent`;
    its wall-clock and engine steps are the shared run's."""
    t0 = time.monotonic()
    steps0 = sim.step_count
    state = [{"agent": a, "ev": ev, "traj": Trajectory(agent=a.kind),
              "best": float("-inf"), "best_s": None, "guard": 0,
              "done": ev.evals >= budget}
             for a, ev in zip(agents_, evaluators)]
    while True:
        live = []
        for st in state:
            if st["done"]:
                continue
            props = list(st["agent"].propose(st["agent"].history))
            if not props:
                st["done"] = True
                continue
            live.append((st, props, st["ev"].evals))
        if not live:
            break
        scores = evaluate_together([(st["ev"], props)
                                    for st, props, _ in live])
        for (st, props, before), sc in zip(live, scores):
            ev, traj = st["ev"], st["traj"]
            obs = [Observation(c, objective(s), s)
                   for c, s in zip(props, sc)]
            st["agent"].observe(obs)
            for o in obs:
                if o.objective > st["best"]:
                    st["best"], st["best_s"] = o.objective, o.score
            traj.evals.append(ev.evals)
            traj.best.append(st["best"])
            traj.wall_s.append(time.monotonic() - t0)
            traj.steps.append(sim.step_count - steps0)
            # a fully-converged agent proposing only table-known points
            # makes no progress against the budget; stop after a few
            # such rounds
            st["guard"] = st["guard"] + 1 if ev.evals == before else 0
            st["done"] = ev.evals >= budget or st["guard"] >= 3
    for st in state:
        if st["best_s"] is not None:
            st["traj"].best_label = st["best_s"].candidate
            st["traj"].best_score = st["best_s"]
    return [st["traj"] for st in state]


def grid_candidates(knobs: Sequence[str] = AGENT_KNOBS, *,
                    points_per_knob: int = 3,
                    policy: Optional[int] = None) -> List[Candidate]:
    """Cartesian ``points_per_knob``-level grid over continuous knobs
    (the search space's corners + midpoints) — the bounded-grid tier the
    agents race against, and the what-if layer's default candidate
    list."""
    axes = []
    for k in knobs:
        lo, hi = SEARCH_BOUNDS[k]
        axes.append((k, tuple(float(v)
                              for v in np.linspace(lo, hi,
                                                   points_per_knob))))
    return [Candidate(policy=policy, cc=tuple(sorted(zip(
        [k for k, _ in axes], vals))))
        for vals in itertools.product(*[v for _, v in axes])]


def grid_reference(panel: Sequence[PanelCell],
                   knobs: Sequence[str] = AGENT_KNOBS, *,
                   points_per_knob: int = 3,
                   policy: Optional[int] = None,
                   evaluator: Optional[PanelEvaluator] = None,
                   **run_kw) -> dict:
    """The bounded-grid tier's winner on the same objective, scored in
    one batched call. Returns the target the agents race toward:
    {label, objective, evals}."""
    cands = grid_candidates(knobs, points_per_knob=points_per_knob,
                            policy=policy)
    ev = evaluator if evaluator is not None else PanelEvaluator(
        panel, **run_kw)
    scores = ev.evaluate(cands)
    objs = [objective(s) for s in scores]
    i = int(np.argmax(objs))
    return {"label": scores[i].candidate, "objective": float(objs[i]),
            "evals": len(cands)}


def compare_agents(agent_kinds: Sequence[str],
                   panel: Sequence[PanelCell], *, budget: int = 32,
                   batch: int = 8, knobs: Sequence[str] = AGENT_KNOBS,
                   seed: int = 0, policy: Optional[int] = None,
                   target: Optional[dict] = None,
                   **run_kw) -> dict:
    """The archgym-style comparison: run each agent kind (fresh
    evaluator each, so no agent reads another's memo table) to the same
    budget, then report per-agent trajectories and evaluations-to-target
    against the bounded-grid winner. The agents run in lock step
    (:func:`run_agents`): one batched run a generation for all of them,
    with the results of running them one after another."""
    if target is None:
        target = grid_reference(panel, knobs, policy=policy, **run_kw)
    report: dict = {"budget": budget, "batch": batch,
                    "knobs": list(knobs), "target": target, "agents": {}}
    agents_ = [make_agent(kind, knobs=knobs, batch=batch, seed=seed,
                          policy=policy) for kind in agent_kinds]
    evs = [PanelEvaluator(panel, **run_kw) for _ in agent_kinds]
    trajs = run_agents(agents_, evs, budget=budget)
    for kind, ev, traj in zip(agent_kinds, evs, trajs):
        d = traj.as_dict()
        d["evals_to_target"] = traj.evals_to(target["objective"])
        d["table_hits"] = ev.table_hits
        report["agents"][kind] = d
    return report
