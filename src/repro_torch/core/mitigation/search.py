"""Batched mitigation search: CC / load-balancing knob spaces swept
through the batched fabric engine.

A :class:`Candidate` is one point of the mitigation space: a routing
policy id (and flowlet gap) and a set of CC scalar overrides, every knob
a ``SimParams`` field bounded by ``cc.SEARCH_BOUNDS``.
:func:`run_candidates` expands (panel cell x candidate x
baseline/congested) into stacked ``SimParams`` and runs the whole search
as ONE ``run_cells_hetero`` batch: the candidates ride the cell axis, the
routing policy per cell is data, and every engine step is one launch of
kernel 1 for all of them.

Two tiers:

* **grid tier**: cartesian expansion of :class:`CCSpace` x
  :class:`RoutingSpace` (:func:`expand`), scored by
  ``score.score_table``;
* **gradient tier** (:func:`gradient_refine`): victim goodput is
  differentiable through the fluid steps, so continuous knobs are
  sigmoid-reparameterized into their bounds and descended with Adam on
  ``torch.autograd`` over a fixed number of steps. Kernel 1 has no
  gradient (nor has the reference's Pallas kernel, whose gradient tier
  runs the plain step off a TPU), so this tier runs the step core's plain
  version, ``core="plain"``, on whatever device it is given.

:func:`simulated_times` is the one simulator-backed point-scoring path;
``autotune.predict_simulated`` is a cached client of it.
"""
from __future__ import annotations

import dataclasses
import itertools
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bench
from repro_torch.core import congestion as cong
from repro_torch.core.envelopes import Profile
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric.cc import SEARCH_BOUNDS
from repro_torch.core.fabric.routing import POLICY_FLOWLET, POLICY_NAMES
from repro_torch.core.fabric.systems import (SystemPreset, default_policy,
                                             get_system)

# knobs that stay integers when lowered into SimParams
_INT_KNOBS = ("kind",)


def check_bounds(name: str, value: float) -> float:
    if name not in SEARCH_BOUNDS:
        raise KeyError(f"unknown mitigation knob {name!r}; "
                       f"known: {sorted(SEARCH_BOUNDS)}")
    lo, hi = SEARCH_BOUNDS[name]
    if not (lo <= value <= hi):
        raise ValueError(f"{name}={value} outside bounds [{lo}, {hi}]")
    return value


@dataclasses.dataclass(frozen=True)
class CCSpace:
    """Bounded CC knob grid: (SimParams field, candidate values) pairs,
    expanded as a cartesian product; values are checked against
    ``cc.SEARCH_BOUNDS`` at construction."""

    knobs: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()

    def __post_init__(self):
        for name, values in self.knobs:
            for v in values:
                check_bounds(name, v)

    @staticmethod
    def of(**knobs) -> "CCSpace":
        return CCSpace(tuple((k, tuple(v)) for k, v in knobs.items()))

    def grid(self) -> List[Dict[str, float]]:
        names = [k for k, _ in self.knobs]
        return [dict(zip(names, vs)) for vs in itertools.product(
            *(vals for _, vals in self.knobs))] or [{}]


@dataclasses.dataclass(frozen=True)
class RoutingSpace:
    """Load-balancing candidates: policy ids plus flowlet gap thresholds
    (the gap axis only multiplies the flowlet policy)."""

    policies: Tuple[int, ...] = ()
    flowlet_gaps_s: Tuple[float, ...] = (200e-6,)

    def __post_init__(self):
        for g in self.flowlet_gaps_s:
            check_bounds("flowlet_gap_s", g)

    def grid(self) -> List[Dict[str, float]]:
        out: List[Dict[str, float]] = []
        for pol in self.policies or (None,):
            gaps = self.flowlet_gaps_s if pol == POLICY_FLOWLET \
                else self.flowlet_gaps_s[:1]
            out.extend({"policy": pol, "flowlet_gap_s": g} for g in gaps)
        return out


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the mitigation space. ``policy=None`` keeps each
    panel cell's system-default policy (CC-only candidates score fairly
    across fabrics with different native routing)."""

    policy: Optional[int] = None
    flowlet_gap_s: float = 200e-6
    cc: Tuple[Tuple[str, float], ...] = ()
    name: str = ""

    def label(self) -> str:
        if self.name:
            return self.name
        pol = "native" if self.policy is None else POLICY_NAMES[self.policy]
        if self.policy == POLICY_FLOWLET:
            pol += f"[{self.flowlet_gap_s * 1e6:g}us]"
        cc = ",".join(f"{k}={v:g}" for k, v in self.cc)
        return pol + (f"|{cc}" if cc else "")

    def apply(self, p: sim.SimParams, default_pol: int) -> sim.SimParams:
        """One cell's parameters (no batch axis) with this candidate's
        policy and knobs; a cc override of ``flowlet_gap_s`` wins over
        the routing axis's."""
        pol = self.policy if self.policy is not None else default_pol
        kw = {"policy": torch.tensor(pol, dtype=torch.int64),
              "flowlet_gap_s": torch.tensor(self.flowlet_gap_s,
                                            dtype=torch.float32)}
        kw.update({k: torch.tensor(v, dtype=torch.int64 if k in _INT_KNOBS
                                   else torch.float32) for k, v in self.cc})
        return dataclasses.replace(
            p, **{k: v.to(p.dt.device) for k, v in kw.items()})


def expand(cc_space: CCSpace = CCSpace(),
           routing_space: RoutingSpace = RoutingSpace()) -> List[Candidate]:
    """Cartesian grid tier: every (routing x CC) combination, checked
    against the knob bounds."""
    out = []
    for r in routing_space.grid():
        for c in cc_space.grid():
            for k, v in c.items():
                check_bounds(k, v)
            out.append(Candidate(policy=r["policy"],
                                 flowlet_gap_s=r["flowlet_gap_s"],
                                 cc=tuple(sorted(c.items()))))
    return out


def default_candidate(name: str = "default") -> Candidate:
    """The fabric's shipped configuration (native policy, stock CC)."""
    return Candidate(name=name)


# --------------------------------------------------------------------------
# Batched execution: (panel cell x candidate x baseline/congested) cells
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PanelCell:
    """One scoring scenario: a (system, allocation, traffic program,
    congestion profile, vector size) cell every candidate is measured
    on. ``jobs`` swaps the victim/aggressor split for a multi-job mix."""

    name: str
    system: SystemPreset
    n_nodes: int
    victim: str
    aggressor: str
    vector_bytes: float
    profile: Profile
    jobs: tuple = ()


@dataclasses.dataclass
class CellRun:
    """Raw per-(cell, candidate) measurements (score.py derives the
    Pareto metrics from these)."""

    cell: str
    candidate: str
    t_uncongested_s: float
    t_congested_s: float
    ratio: float
    victim_bytes: float  # delivered by victim flows, congested lane
    aggr_bytes: float  # delivered by aggressor/background flows
    sim_time_s: float
    jain: float  # fairness over victim flows' delivered bytes
    # a lane completed zero iterations within the step budget: times and
    # ratio are NaN, and score.aggregate leaves the cell out (DNF)
    dnf: bool = False
    warmup_ok: bool = True


def _jain(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    x = x[x > 0]
    if len(x) == 0:
        return 1.0
    return float((x.sum() ** 2) / (len(x) * np.sum(x * x)))


def candidate_rows_inputs(panel: Sequence[PanelCell],
                          cand_rows: Sequence[Sequence[Candidate]]):
    """What :func:`run_candidate_rows` runs: each cell's case and dt, the
    panel's stacked bucket geometries, and params with (cell, candidate x
    {baseline, congested}) leading axes, on the CPU. Returns ``(cases,
    dts, stacked, params)``."""
    with_ft = cong.needs_fault_table([c.profile for c in panel])
    cases = [bench.build_case(c.system, c.n_nodes, c.victim, c.aggressor,
                              jobs=list(c.jobs) or None,
                              policy_tables=True,
                              intra_node=c.profile.node_cap_frac > 0)
             for c in panel]
    dims, stacked = bench.bucket_stack([c.geom for c in cases])
    dts, rows = [], []
    for cell, case, cands in zip(panel, cases, cand_rows):
        dt = bench.choose_dt(case.topo, case.n_victims, cell.vector_bytes,
                             case.lat(), n_phases=case.max_phases)
        dts.append(dt)
        lane = []
        for cand in cands:
            for prof in (cong.no_congestion(), cell.profile):
                p = case.cell_params(cell.vector_bytes, prof, dt,
                                     n_flows=dims.n_flows,
                                     with_fault_table=with_ft)
                lane.append(cand.apply(p, case.policy))
        rows.append(sim.stack_params(lane))
    return cases, dts, stacked, sim.stack_params(rows)


def run_candidate_rows(panel: Sequence[PanelCell],
                       cand_rows: Sequence[Sequence[Candidate]], *,
                       n_iters: int = 12, warmup: int = 3,
                       max_steps: int = 200_000, chunk: int = 2048,
                       stride: int = 8, device=None, mesh=None,
                       launcher=None) -> List[CellRun]:
    """Per-cell candidate rows in one batched run: ``cand_rows[i]`` is the
    candidate list measured on ``panel[i]``; rows share one length (the
    sub-cell axis is rectangular), which is what lets the what-if server
    (runtime/whatif.py) coalesce different queries' rows into one run.
    Panel geometries carry the ECMP and NSLB tables (a candidate may
    select either as data) and pad into one bucket; a faulted cell
    anywhere puts the inert fault table on every cell, and a node-capped
    cell arms its case's intra-node stage. ``mesh``/``launcher`` split
    the candidate lanes across devices (launch/sweep.py) in place of
    ``device``."""
    if len(cand_rows) != len(panel):
        raise ValueError(f"{len(cand_rows)} candidate rows for "
                         f"{len(panel)} panel cells")
    widths = {len(r) for r in cand_rows}
    if len(widths) != 1:
        raise ValueError(f"candidate rows must share one length, got "
                         f"{sorted(widths)}")
    launcher = bench._resolve_launcher(mesh, launcher, shard_axis="lane")
    if launcher is None:
        device = sim.resolve_device(device)
    bench.check_iter_budget(n_iters)
    cases, dts, stacked, params = candidate_rows_inputs(panel, cand_rows)
    kw = dict(chunk=chunk, max_chunks=-(-max_steps // chunk), stride=stride)
    if launcher is not None:
        out = launcher(stacked, params, n_iters, **kw)
    else:
        out = sim.run_cells_hetero(stacked, params, n_iters, device=device,
                                   **kw)
    runs: List[CellRun] = []
    fbytes = np.asarray(out["fbytes"])
    t_all = np.asarray(out["t"])
    for ci, (cell, case, dt) in enumerate(zip(panel, cases, dts)):
        lat = case.lat()
        F = case.geom.n_flows
        vmask = np.asarray(case.is_victim, bool)
        for ki, cand in enumerate(cand_rows[ci]):
            base_i, cong_i = 2 * ki, 2 * ki + 1
            base = sim.summarize(out, n_iters=n_iters, warmup=warmup, dt=dt,
                                 chunk=chunk, stride=stride,
                                 cell=(ci, base_i))
            res = sim.summarize(out, n_iters=n_iters, warmup=warmup, dt=dt,
                                chunk=chunk, stride=stride,
                                cell=(ci, cong_i))
            t_u = bench.mean_iter_time(base, lat)
            t_c = bench.mean_iter_time(res, lat)
            dnf = base.n_done == 0 or res.n_done == 0
            fb = fbytes[ci, cong_i][:F]
            runs.append(CellRun(
                cell=cell.name, candidate=cand.label(),
                t_uncongested_s=t_u, t_congested_s=t_c,
                ratio=float("nan") if dnf
                else (t_u / t_c if t_c > 0 else 0.0),
                victim_bytes=float(fb[vmask].sum()),
                aggr_bytes=float(fb[~vmask].sum()),
                sim_time_s=float(t_all[ci, cong_i]),
                jain=_jain(fb[vmask]),
                dnf=dnf,
                warmup_ok=base.warmup_ok and res.warmup_ok))
    return runs


def run_candidates(panel: Sequence[PanelCell],
                   candidates: Sequence[Candidate], *,
                   n_iters: int = 12, warmup: int = 3,
                   max_steps: int = 200_000, chunk: int = 2048,
                   stride: int = 8, device=None, mesh=None,
                   launcher=None) -> List[CellRun]:
    """Score every candidate on every panel cell in one batched run (the
    uniform-row case of :func:`run_candidate_rows`): geometries pad into
    one bucket, params carry (cell, candidate x {baseline, congested})
    sub-cells. On ``device`` (default: the CUDA device), or with the
    candidate lanes split across a ``mesh``'s devices (or by a
    ``launcher``, launch/sweep.py), bit-identical to one device."""
    return run_candidate_rows(panel, [list(candidates)] * len(panel),
                              n_iters=n_iters, warmup=warmup,
                              max_steps=max_steps, chunk=chunk,
                              stride=stride, device=device, mesh=mesh,
                              launcher=launcher)


# --------------------------------------------------------------------------
# Shared simulator-backed point scoring (autotune's table tier)
# --------------------------------------------------------------------------


@lru_cache(maxsize=1024)
def _times_table(system_name: str, n_nodes: int, victim: str,
                 aggressor: str, vector_bytes: float, profile: Profile,
                 candidate: Candidate, n_iters: int, warmup: int,
                 device: str) -> Tuple[float, float]:
    cell = PanelCell(name="point", system=get_system(system_name),
                     n_nodes=n_nodes, victim=victim, aggressor=aggressor,
                     vector_bytes=float(vector_bytes), profile=profile)
    run = run_candidates([cell], [candidate], n_iters=n_iters,
                         warmup=warmup, device=device)[0]
    return run.t_uncongested_s, run.t_congested_s


def simulated_times(system_name: str, n_nodes: int, victim: str,
                    aggressor: str, vector_bytes: float,
                    profile: Profile, *,
                    candidate: Optional[Candidate] = None,
                    n_iters: int = 20, warmup: int = 4, device=None
                    ) -> Tuple[float, float]:
    """(t_uncongested, t_congested) for one cell: THE simulator-backed
    scoring path, shared by the mitigation search (a one-candidate
    panel) and ``autotune.predict_simulated``. The table behind it keys on
    the candidate and the device as well as the point, so a search agent
    re-scoring a point already evaluated reads the table (clear it with
    ``_times_table.cache_clear``)."""
    cand = candidate if candidate is not None else default_candidate()
    return _times_table(system_name, int(n_nodes), victim, aggressor,
                        float(vector_bytes), profile, cand, int(n_iters),
                        int(warmup), str(sim.resolve_device(device)))


def sawtooth_cv(system_name: str, n_nodes: int, coll: str,
                vector_bytes: float, candidate: Candidate, *,
                n_iters: int = 25, dt: float = 20e-6,
                max_steps: int = 200_000, device=None) -> float:
    """Coefficient of variation of the steady-state victim goodput trace
    of a self-congestion run (no aggressors, the Fig. 3 path) under
    ``candidate``: high = bang-bang CC oscillation, low = damped."""
    return sawtooth_cvs(system_name, n_nodes, coll, vector_bytes,
                        [candidate], n_iters=n_iters, dt=dt,
                        max_steps=max_steps, device=device)[0]


def sawtooth_cvs(system_name: str, n_nodes: int, coll: str,
                 vector_bytes: float, candidates: Sequence[Candidate], *,
                 n_iters: int = 25, dt: float = 20e-6,
                 max_steps: int = 200_000, device=None) -> List[float]:
    """:func:`sawtooth_cv` of several candidates, each a cell of one
    batched run (a cell's trace does not depend on the batch)."""
    system = get_system(system_name)
    geom, params = bench.goodput_case(system, n_nodes, coll, vector_bytes,
                                      dt=dt)
    chunk, stride = 2048, 8
    out = sim.run_cells(geom, sim.stack_params(
        [c.apply(params, default_policy(system)) for c in candidates]),
        n_iters, chunk=chunk, max_chunks=-(-max_steps // chunk),
        stride=stride, device=device)
    cvs = []
    for i in range(len(candidates)):
        res = sim.summarize(out, n_iters=n_iters, warmup=5, dt=dt,
                            chunk=chunk, stride=stride, cell=i)
        tr = res.victim_rate_trace
        tr = tr[len(tr) // 3:]
        tr = tr[tr > 0]
        cvs.append(0.0 if len(tr) == 0 or tr.mean() == 0
                   else float(tr.std() / tr.mean()))
    return cvs


# --------------------------------------------------------------------------
# Gradient tier: differentiate victim goodput through the fluid steps
# --------------------------------------------------------------------------

# continuous knobs the gradient tier may descend (ints excluded)
GRAD_KNOBS = tuple(k for k in SEARCH_BOUNDS if k not in _INT_KNOBS)


def _to_bounds(theta, lo, hi):
    return lo + (hi - lo) * (1.0 / (1.0 + torch.exp(-theta)))


def _from_bounds(v, lo, hi):
    frac = np.clip((v - lo) / (hi - lo), 1e-4, 1 - 1e-4)
    return float(np.log(frac / (1 - frac)))


def victim_objective(geom: sim.FabricGeometry, p: sim.SimParams,
                     n_steps: int) -> torch.Tensor:
    """Negative mean victim goodput over ``n_steps`` steps (no early exit)
    of a stacked batch of one cell: the differentiable stand-in for victim
    slowdown. The step core runs its plain version (``core="plain"``):
    kernel 1 has no gradient."""
    state = sim.init_state(geom, p)
    consts = sim.run_constants(p)
    gps = []
    for _ in range(n_steps):
        state, gp = sim._step_impl(geom, p, state, with_aux=False,
                                   core="plain", consts=consts)
        gps.append(gp)
    return -torch.stack(gps).mean()


def gradient_refine(geom: sim.FabricGeometry, base: sim.SimParams,
                    knobs: Sequence[str], *, steps: int = 8,
                    lr: float = 0.25, n_steps: int = 800,
                    device=None) -> Dict:
    """Descend the selected continuous knobs from ``base`` (one cell, no
    batch axis), each mapped into its bounds through a sigmoid, with Adam
    on ``torch.autograd``. The steps run the step core's plain version
    (``core="plain"``, :func:`victim_objective`) on ``device`` (default:
    the CUDA device). Returns the best knob values seen and the objective
    history."""
    knobs = list(knobs)
    for k in knobs:
        if k not in GRAD_KNOBS:
            raise KeyError(f"{k!r} is not a continuous searchable knob")
    dev = sim.resolve_device(device)
    geom = geom.to(dev)
    base = sim.stack_params([base]).to(dev)
    bounds = np.array([SEARCH_BOUNDS[k] for k in knobs], np.float64)
    lo = torch.tensor(bounds[:, 0], dtype=torch.float32, device=dev)
    hi = torch.tensor(bounds[:, 1], dtype=torch.float32, device=dev)
    theta0 = torch.tensor(
        [_from_bounds(float(getattr(base, k)[0]), *SEARCH_BOUNDS[k])
         for k in knobs], dtype=torch.float32, device=dev)

    def value_and_grad(theta):
        theta = theta.detach().requires_grad_(True)
        vals = _to_bounds(theta, lo, hi)
        p = dataclasses.replace(base, **{k: vals[i].reshape(1)
                                         for i, k in enumerate(knobs)})
        val = victim_objective(geom, p, n_steps)
        (g,) = torch.autograd.grad(val, theta)
        return float(val.detach()), g

    m = torch.zeros_like(theta0)
    v = torch.zeros_like(theta0)
    theta, best_theta = theta0, theta0
    best = float("inf")
    history = []
    for t in range(1, steps + 1):
        val, g = value_and_grad(theta)
        history.append(val)
        if val < best:
            best, best_theta = val, theta
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        theta = theta - lr * mh / (torch.sqrt(vh) + 1e-8)
    vals = _to_bounds(best_theta, lo, hi).cpu().numpy()
    return {"knobs": {k: float(vals[i]) for i, k in enumerate(knobs)},
            "objective": best, "history": history}
