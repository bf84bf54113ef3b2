"""The paper's measurement protocol (§III): run the victim collective for a
fixed number of iterations under a congestion profile, discard warmup,
report mean iteration time and the uncongested/congested ratio.

* :func:`run_point` — one heatmap cell (baseline + congested, batched as
  a 2-cell grid).
* :func:`run_grid` — a whole (vector size x profile x baseline/congested)
  grid on ONE flow set, executed as one batched run
  (simulator.run_cells): all cells advance together, each stops when its
  primary job has finished.
* :func:`run_scale_grid` — heterogeneous ``(system, n_nodes)`` cells,
  their geometries padded to one bucket and run as one batch
  (simulator.run_cells_hetero; paper Figs. 7-8).
* :func:`goodput_traces` — aggressor-free runs as one batch and their
  victim goodput traces (paper Fig. 3 self-congestion).

All run on the CUDA device unless ``device`` says otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import congestion as cong
from repro_torch.core import traffic
from repro_torch.core.fabric.routing import splitmix64
from repro_torch.core.fabric.simulator import (TDONE_SLOTS, FabricGeometry,
                                               SimParams, _drop_warmup,
                                               bucket_dims,
                                               check_iter_budget,
                                               make_geometry, make_params,
                                               pad_geometry, resolve_device,
                                               run_cells, run_cells_hetero,
                                               stack_geometries,
                                               stack_params, summarize)
from repro_torch.core.fabric.systems import (SystemPreset, default_policy,
                                             get_system)  # noqa: F401


@dataclasses.dataclass
class BenchResult:
    system: str
    n_nodes: int
    victim: str
    aggressor: str
    profile: str
    vector_bytes: float
    t_uncongested_s: float
    t_congested_s: float
    ratio: float  # uncongested / congested (paper Fig. 5-8; higher = better)
    victim_goodput_gbps: float
    n_iters: tuple
    # per-job mean iteration times of the congested cell:
    # ((job_name, t_mean_s, n_done), ...)
    job_times: tuple = ()
    # False when either lane finished inside its warmup window
    warmup_ok: bool = True
    # did-not-finish: a lane completed zero iterations within the budget
    dnf: bool = False


def victim_label(victim_coll: str, phased: bool) -> str:
    """The reported victim column: the collective kind plus '+phased'
    when the primary job runs its step schedule."""
    return victim_coll + ("+phased" if phased else "")


def resolve_victim_label(victim_coll: str, phased: bool, jobs=None) -> str:
    """The victim label :func:`build_case` gives a (victim, phased, jobs)
    request: scenario cache keys use it, so a key and its row agree."""
    if jobs:
        return victim_label(victim_coll or jobs[0].collective,
                            bool(jobs[0].phased))
    return victim_label(victim_coll, phased)


def mean_iter_time(res, lat: float) -> float:
    """Reported per-iteration time of one summarized run: mean simulated
    iteration + analytic per-step latency + mean queueing delay; NaN when
    the run completed zero iterations."""
    if len(res.iter_times) == 0:
        return float("nan")
    return float(np.mean(res.iter_times)) + lat + res.mean_qdelay_s


_TOPO_CACHE: dict = {}


def _fn_fingerprint(fn) -> tuple:
    """What identifies a topology builder: its bytecode, constants (a
    nested code object by its repr), closure values and defaults, so a
    preset given another builder under the same name misses the cache."""
    code = getattr(fn, "__code__", None)
    if code is None:
        return (repr(fn),)
    consts = tuple(
        c if isinstance(c, (int, float, str, bytes, bool, type(None)))
        else repr(c) for c in code.co_consts)
    closure = tuple(repr(c.cell_contents)
                    for c in (getattr(fn, "__closure__", None) or ()))
    return (code.co_code, consts, closure, repr(fn.__defaults__))


def _topo_cache_key(system: SystemPreset, n: int) -> tuple:
    return (system.name, system.fabric, system.machine_nodes,
            system.k_max, system.static_routing,
            _fn_fingerprint(system.make_topology), n)


def clear_topology_cache() -> None:
    """Drop every cached machine topology."""
    _TOPO_CACHE.clear()


def machine_topology(system: SystemPreset, n_nodes: int = 0):
    """Full-machine topology, cached per preset and size; the key holds
    the preset's fields and a fingerprint of its builder, so two presets
    that share a name but not a builder get their own. Testbed systems
    (``machine_nodes == 0``) are built at the allocation size."""
    n = system.machine_nodes or (n_nodes or 8)
    key = _topo_cache_key(system, n)
    if key not in _TOPO_CACHE:
        _TOPO_CACHE[key] = system.make_topology(n)
    return _TOPO_CACHE[key]


def allocate(system: SystemPreset, n_nodes: int, seed: int = 7) -> np.ndarray:
    """A scattered sample of the machine, as a busy batch scheduler hands
    out; ``seed`` and ``n_nodes`` mix through splitmix64."""
    machine = system.machine_nodes or n_nodes
    if n_nodes >= machine:
        return np.arange(machine)
    mixed = splitmix64((np.uint64(seed) << np.uint64(32))
                       | np.uint64(np.uint32(n_nodes)))
    rng = np.random.RandomState(int(mixed & np.uint64(0xFFFFFFFF)))
    return np.sort(rng.choice(machine, size=n_nodes, replace=False))


# --------------------------------------------------------------------------
# dt selection
# --------------------------------------------------------------------------

# power-of-two microsecond ladder: neighboring grid cells snap to shared dt
DT_LADDER_S = tuple(2.0 ** k * 1e-6 for k in range(8))  # 1us .. 128us


def quantize_dt(dt_raw: float) -> float:
    """Snap down to the nearest ladder step (finer dt = more accurate)."""
    for dt in reversed(DT_LADDER_S):
        if dt <= dt_raw:
            return dt
    return DT_LADDER_S[0]


def choose_dt(topo, n_victims: int, vector_bytes: float, lat: float,
              n_phases: int = 1) -> float:
    """dt sized so one uncongested iteration spans ~100 steps, and each
    of ``n_phases`` barrier-gated phases at least ~8 steps."""
    per_flow = vector_bytes / max(n_victims, 1)
    t_est = max(per_flow / (topo.caps.max()), 2e-6) * 2 + lat
    steps = max(100, 8 * int(n_phases))
    return quantize_dt(float(np.clip(t_est / steps, 1e-6, 200e-6)))


# --------------------------------------------------------------------------
# Case construction: one flow set, reused across a grid of cells
# --------------------------------------------------------------------------


@dataclasses.dataclass
class GridCase:
    """One (system, allocation, traffic program) experiment; the
    unit-vector flow program to be scaled per cell."""

    system: SystemPreset
    n_nodes: int
    victim_coll: str
    aggr_coll: str
    topo: object
    geom: FabricGeometry
    unit_bytes: np.ndarray  # (F,) per-flow bytes at vector_bytes == 1.0
    is_victim: np.ndarray  # (F,)
    host_caps: np.ndarray  # (F,)
    n_victims: int
    sweep_mask: np.ndarray = None  # (F,) flows whose bytes sweep
    job_names: List[str] = None
    max_phases: int = 1
    primary_phased: bool = False  # job 0 runs a phased step schedule
    policy: int = 0  # per-cell routing policy id (the system default)

    def __post_init__(self):
        if self.sweep_mask is None:
            self.sweep_mask = np.asarray(self.is_victim, bool)
        if self.job_names is None:
            self.job_names = ["victim", "aggressor"]

    def cell_params(self, vector_bytes: float, profile: cong.Profile,
                    dt: float, n_flows: Optional[int] = None,
                    with_fault_table: bool = False) -> SimParams:
        """One cell's parameters (no batch axis); ``n_flows`` pads the
        flow axis to a geometry bucket's width (pad flows: 0 bytes, never
        alive, and a host cap of 1.0 so no divide sees 0).

        The profile's fault events become its fault table;
        ``with_fault_table`` puts the inert all-``none`` table on a cell
        without events, so it stacks with cells that have some. The
        intra-node capacity is ``node_cap_frac`` times the case's fastest
        NIC (its real flows only), or inf when the profile leaves the
        stage off."""
        bpi = np.where(self.sweep_mask, self.unit_bytes * vector_bytes,
                       self.unit_bytes)
        host_caps = self.host_caps
        if n_flows is not None and n_flows > len(bpi):
            bpi = traffic.pad_rows(bpi, n_flows, 0.0)
            host_caps = traffic.pad_rows(host_caps, n_flows, 1.0)
        fault = profile.fault_params()
        if fault is None and with_fault_table:
            fault = cong.no_fault_table()
        node_cap = np.inf if profile.node_cap_frac <= 0 else \
            float(profile.node_cap_frac) * float(np.max(self.host_caps))
        return make_params(self.system.cc, dt=dt, bytes_per_iter=bpi,
                           host_caps=host_caps, env=profile.params(),
                           policy=self.policy, fault=fault,
                           node_cap=node_cap)

    def lat(self) -> float:
        return cong.latency_model(self.victim_coll, self.n_victims)


def build_case(system: SystemPreset, n_nodes: int, victim_coll: str,
               aggr_coll: str, topo=None,
               nodes: Optional[np.ndarray] = None, *,
               phased: bool = False,
               jobs: Optional[Sequence[traffic.JobSpec]] = None,
               policy_tables: bool = False,
               intra_node: bool = False,
               seed: int = 7) -> GridCase:
    """Build the flow program + geometry once for a whole grid of cells.

    Default: the paper's two-job victim/aggressor split; ``phased=True``
    lowers the victim's step schedule; ``jobs`` replaces the split with
    an explicit multi-job program; ``intra_node`` arms the intra-node
    stage in the geometry (each cell's ``node_cap`` sets its capacity)."""
    if topo is None:
        topo = machine_topology(system, n_nodes)
    if nodes is None:
        nodes = allocate(system, n_nodes, seed=seed)
    if jobs is not None:
        jobs = traffic.split_nodes(nodes, list(jobs))
        jobs = [dataclasses.replace(j, vector_bytes=1.0)
                if j.sweep_bytes and not j.endless else j for j in jobs]
        flows = cong.build_program_flowset(
            topo, jobs, routing_mode=system.static_routing,
            k_max=system.k_max, policy_tables=policy_tables)
        victim_coll = victim_coll or jobs[0].collective
        aggr_coll = aggr_coll or "+".join(j.name for j in jobs[1:])
        n_victims = len(jobs[0].nodes)
    else:
        # the paper's §III-A interleaved split (applied even with no
        # aggressor collective, so baseline and congested cells share
        # the victim set)
        vidx, aidx = cong.interleaved_split(n_nodes)
        victims, aggressors = nodes[vidx], nodes[aidx]
        flows = cong.build_flowset(topo, victims, aggressors, victim_coll,
                                   aggr_coll, 1.0,
                                   routing_mode=system.static_routing,
                                   k_max=system.k_max, phased=phased,
                                   policy_tables=policy_tables)
        n_victims = len(victims)
    geom = make_geometry(topo, flows, intra_node=intra_node)
    return GridCase(system=system, n_nodes=n_nodes, victim_coll=victim_coll,
                    aggr_coll=aggr_coll, topo=topo, geom=geom,
                    unit_bytes=flows.bytes_per_iter.copy(),
                    is_victim=flows.is_victim, host_caps=flows.host_caps,
                    n_victims=n_victims,
                    sweep_mask=np.asarray(flows.sweep_mask, bool),
                    job_names=list(flows.job_names),
                    max_phases=int(np.max(flows.n_phases)),
                    primary_phased=bool(jobs[0].phased) if jobs is not None
                    else phased,
                    policy=default_policy(system))


# --------------------------------------------------------------------------
# Batched grid runner
# --------------------------------------------------------------------------


def _job_times(out, case: GridCase, *, n_iters, warmup, cell) -> tuple:
    """Per-job mean iteration times of one cell (jobs that closed at
    least one program iteration)."""
    it = np.asarray(out["it"])[cell]
    td = np.asarray(out["t_done"])[cell]
    rows = []
    for ji, name in enumerate(case.job_names):
        n_done = min(int(it[ji]), n_iters, TDONE_SLOTS)
        if n_done <= 0:
            continue
        times = np.diff(np.concatenate([[0.0], td[ji][:n_done]]))
        times, _ = _drop_warmup(times, n_done, warmup)
        if len(times):
            rows.append((name, float(np.mean(times)), n_done))
    return tuple(rows)


def _cell_dts(case: GridCase, sizes: Sequence[float], n_profiles: int,
              dt: Optional[float], lat: float) -> List[float]:
    """One dt per sub-cell (size-major, baseline + profiles per size),
    chosen per cell on the shared power-of-two ladder."""
    dts: List[float] = []
    for v in sizes:
        cell_dt = dt if dt is not None else choose_dt(
            case.topo, case.n_victims, float(v), lat,
            n_phases=case.max_phases)
        dts.extend([cell_dt] * (1 + n_profiles))
    return dts


def _result(case: GridCase, out: dict, base, res, *, profile: str,
            vector_bytes: float, n_iters: int, warmup: int,
            cell: int) -> BenchResult:
    lat = case.lat()
    t_u = mean_iter_time(base, lat)
    t_c = mean_iter_time(res, lat)
    dnf = base.n_done == 0 or res.n_done == 0
    return BenchResult(
        system=case.system.name, n_nodes=case.n_nodes,
        victim=victim_label(case.victim_coll, case.primary_phased),
        aggressor=case.aggr_coll or "none", profile=profile,
        vector_bytes=float(vector_bytes), t_uncongested_s=t_u,
        t_congested_s=t_c,
        ratio=float("nan") if dnf else (t_u / t_c if t_c > 0 else 0.0),
        victim_goodput_gbps=float(
            np.mean(res.victim_rate_trace[-200:]) * 8 / 1e9)
        if len(res.victim_rate_trace) else 0.0,
        n_iters=(base.n_done, res.n_done),
        job_times=_job_times(out, case, n_iters=n_iters, warmup=warmup,
                             cell=cell),
        warmup_ok=base.warmup_ok and res.warmup_ok,
        dnf=dnf)


def _grid_results(case: GridCase, out: dict, sizes: Sequence[float],
                  profiles: Sequence[cong.Profile], dts: Sequence[float], *,
                  n_iters: int, warmup: int, chunk: int,
                  stride: int) -> List[BenchResult]:
    """Marshal one case's (size x baseline/profile) sub-cells out of a
    batched run."""
    per_prof = 1 + len(profiles)
    results = []
    for si, v in enumerate(sizes):
        base_i = si * per_prof
        base = summarize(out, n_iters=n_iters, warmup=warmup, dt=dts[base_i],
                         chunk=chunk, stride=stride, cell=base_i)
        for pi, prof in enumerate(profiles):
            ci = base_i + 1 + pi
            res = summarize(out, n_iters=n_iters, warmup=warmup, dt=dts[ci],
                            chunk=chunk, stride=stride, cell=ci)
            results.append(_result(case, out, base, res,
                                   profile=prof.label(), vector_bytes=v,
                                   n_iters=n_iters, warmup=warmup, cell=ci))
    return results


def _resolve_launcher(mesh, launcher, shard_axis: str = "cell"):
    """Launcher resolution shared by the grid runners and the mitigation
    search: an explicit ``launcher`` wins; a ``mesh`` alone gets
    launch.sweep's per-device dispatcher over ``shard_axis`` (imported
    here, so that core does not import the launch layer)."""
    if launcher is not None or mesh is None:
        return launcher
    from repro_torch.launch.sweep import device_launcher
    return device_launcher(mesh, shard_axis=shard_axis)


def run_grid(system: Union[SystemPreset, Sequence["ScaleCell"]],
             n_nodes: int, victim_coll: str, aggr_coll: str,
             sizes: Sequence[float],
             profiles: Sequence[cong.Profile], *, n_iters: int = 60,
             warmup: int = 10, dt: Optional[float] = None,
             max_steps: int = 200_000, chunk: int = 2048,
             trace_stride: int = 8, phased: bool = False,
             jobs: Optional[Sequence[traffic.JobSpec]] = None,
             device=None, core: Optional[str] = None, mesh=None,
             launcher=None) -> List[BenchResult]:
    """All (vector size x profile) cells of one experiment in a single
    batched run: a per-size baseline (aggressors/background jobs off)
    plus one congested cell per profile, sharing one geometry.

    ``system`` may also be a list of ``(system, n_nodes)`` cells:
    heterogeneous topologies and scales, run through
    :func:`run_scale_grid` (``n_nodes`` is then ignored). A ``mesh`` or
    ``launcher`` (launch/sweep.py) also takes that route, for one system
    too: a cell runs bit for bit as it does alone, so the rows are the
    same."""
    if not isinstance(system, SystemPreset) or mesh is not None \
            or launcher is not None:
        cells = system if not isinstance(system, SystemPreset) \
            else [(system, n_nodes)]
        return run_scale_grid(cells, victim_coll, aggr_coll, sizes,
                              profiles, n_iters=n_iters, warmup=warmup,
                              dt=dt, max_steps=max_steps, chunk=chunk,
                              trace_stride=trace_stride, phased=phased,
                              jobs=jobs, device=device, core=core,
                              mesh=mesh, launcher=launcher)
    device = resolve_device(device)
    check_iter_budget(n_iters)
    case, dts, params = grid_inputs(system, n_nodes, victim_coll, aggr_coll,
                                    sizes, profiles, dt=dt, phased=phased,
                                    jobs=jobs)
    max_chunks = -(-max_steps // chunk)
    out = run_cells(case.geom, params, n_iters, chunk=chunk,
                    max_chunks=max_chunks, stride=trace_stride,
                    device=device, core=core)
    return _grid_results(case, out, sizes, profiles, dts, n_iters=n_iters,
                         warmup=warmup, chunk=chunk, stride=trace_stride)


def grid_inputs(system: SystemPreset, n_nodes: int, victim_coll: str,
                aggr_coll: str, sizes: Sequence[float],
                profiles: Sequence[cong.Profile], *,
                dt: Optional[float] = None, phased: bool = False,
                jobs: Optional[Sequence[traffic.JobSpec]] = None):
    """What :func:`run_grid` runs on one system: its case, each cell's
    dt, and the stacked params of every (size x baseline/profile) cell.
    Returns ``(case, dts, params)``."""
    # a cell with faults puts the inert table on the others (cells stack
    # only with one layout); a node-capped cell arms the intra-node stage
    # for the whole case (inert at inf)
    with_ft = cong.needs_fault_table(profiles)
    case = build_case(system, n_nodes, victim_coll, aggr_coll,
                      phased=phased, jobs=jobs,
                      intra_node=any(p.node_cap_frac > 0 for p in profiles))
    dts = _cell_dts(case, sizes, len(profiles), dt, case.lat())
    cells = [(float(v), prof) for v in sizes
             for prof in [cong.no_congestion()] + list(profiles)]
    params = stack_params([case.cell_params(v, prof, d,
                                            with_fault_table=with_ft)
                           for (v, prof), d in zip(cells, dts)])
    return case, dts, params


# --------------------------------------------------------------------------
# Scale-batched grids: heterogeneous (system, n_nodes) cells in one batch
# --------------------------------------------------------------------------

# a system preset (or its name) and an allocation size
ScaleCell = Tuple[Union[str, SystemPreset], int]


def _round_pow2(x: int) -> int:
    """The reference's bucket-size policy: a dim rounded up to a power of
    two (there, so different cell sets share XLA compiles)."""
    return 1 << max(0, int(x) - 1).bit_length()


def bucket_stack(geoms: Sequence[FabricGeometry]):
    """Pad geometries to one bucket and stack them for
    simulator.run_cells_hetero; returns ``(dims, stacked)``.

    The port pads to the elementwise maximum of the members' dims, not to
    powers of two (:func:`_round_pow2`) as the reference does: the
    rounding only lets XLA reuse a compile, and PyTorch compiles nothing,
    while it would nearly double the links of Fig. 8's alltoall bucket
    (LUMI at 256 nodes: 34,300 to 65,537) and with them every step's
    work.

    Where some member has fewer flows than the bucket, the bucket has one
    source more than any member: pad flows take source ``n_src - 1``
    (:func:`pad_geometry`), and kernel 1 sets a source's summation order
    by how many flows it has (a fold past ``SERIAL_MAX`` is a warp's), so
    a pad flow must not join a real source, even with 0 bytes."""
    dims = bucket_dims(geoms)
    if any(g.n_flows < dims.n_flows for g in geoms):
        dims = dataclasses.replace(dims, n_src=dims.n_src + 1)
    return dims, stack_geometries([pad_geometry(g, dims) for g in geoms])


@dataclasses.dataclass
class PendingGrid:
    """A dispatched scale grid: :meth:`results` marshals its outputs into
    BenchResults, cells major, then sizes, then baseline/profiles."""

    cases: List[GridCase]
    out: dict  # run_cells_hetero's outputs, leading axes (cell, sub-cell)
    sizes: tuple
    profiles: tuple
    all_dts: List[List[float]]
    n_iters: int
    warmup: int
    chunk: int
    stride: int

    def results(self) -> List[BenchResult]:
        return [r for k, case in enumerate(self.cases)
                for r in _grid_results(case, {n: v[k] for n, v in
                                              self.out.items()},
                                       self.sizes, self.profiles,
                                       self.all_dts[k],
                                       n_iters=self.n_iters,
                                       warmup=self.warmup, chunk=self.chunk,
                                       stride=self.stride)]


def launch_scale_grid(cells: Sequence[ScaleCell], victim_coll: str,
                      aggr_coll: str, sizes: Sequence[float],
                      profiles: Sequence[cong.Profile], *, n_iters: int = 60,
                      warmup: int = 10, dt: Optional[float] = None,
                      max_steps: int = 200_000, chunk: int = 2048,
                      trace_stride: int = 8, phased: bool = False,
                      jobs: Optional[Sequence[traffic.JobSpec]] = None,
                      device=None, core: Optional[str] = None, mesh=None,
                      launcher=None) -> PendingGrid:
    """Build a cross-scale grid, pad its geometries into one bucket
    (:func:`bucket_stack`) and run every (cell x size x baseline/profile)
    sub-cell as one batch; returns the :class:`PendingGrid`. The port's
    engine runs to the end before it returns (it syncs once a chunk).
    ``mesh``/``launcher`` split the batch's cells across devices
    (launch/sweep.py) in place of ``device``."""
    launcher = _resolve_launcher(mesh, launcher)
    if launcher is None:
        device = resolve_device(device)
    check_iter_budget(n_iters)
    sizes, profiles = tuple(sizes), tuple(profiles)
    if not cells:
        return PendingGrid([], {}, sizes, profiles, [], n_iters, warmup,
                           chunk, trace_stride)
    cases, all_dts, stacked, params = scale_grid_inputs(
        cells, victim_coll, aggr_coll, sizes, profiles, dt=dt, phased=phased,
        jobs=jobs)
    kw = dict(chunk=chunk, max_chunks=-(-max_steps // chunk),
              stride=trace_stride, core=core)
    if launcher is not None:
        out = launcher(stacked, params, n_iters, **kw)
    else:
        out = run_cells_hetero(stacked, params, n_iters, device=device,
                               **kw)
    return PendingGrid(cases, out, sizes, profiles, all_dts, n_iters,
                       warmup, chunk, trace_stride)


def scale_grid_inputs(cells: Sequence[ScaleCell], victim_coll: str,
                      aggr_coll: str, sizes: Sequence[float],
                      profiles: Sequence[cong.Profile], *,
                      dt: Optional[float] = None, phased: bool = False,
                      jobs: Optional[Sequence[traffic.JobSpec]] = None):
    """What :func:`launch_scale_grid` runs: each cell's case and dts, the
    bucket's stacked geometries (:func:`bucket_stack`) and params with
    (cell, sub-cell) leading axes, for
    simulator.run_cells_hetero. Returns ``(cases, all_dts, stacked,
    params)``."""
    with_ft = cong.needs_fault_table(profiles)
    intra = any(p.node_cap_frac > 0 for p in profiles)
    cases = [build_case(get_system(s) if isinstance(s, str) else s, int(n),
                        victim_coll, aggr_coll, phased=phased, jobs=jobs,
                        intra_node=intra)
             for s, n in cells]
    dims, stacked = bucket_stack([case.geom for case in cases])
    all_dts = [_cell_dts(case, sizes, len(profiles), dt, case.lat())
               for case in cases]
    sub_cells = [(float(v), prof) for v in sizes
                 for prof in [cong.no_congestion(), *profiles]]
    params = stack_params([
        stack_params([case.cell_params(v, prof, d, n_flows=dims.n_flows,
                                       with_fault_table=with_ft)
                      for (v, prof), d in zip(sub_cells, all_dts[k])])
        for k, case in enumerate(cases)])
    return cases, all_dts, stacked, params


def run_scale_grid(cells: Sequence[ScaleCell], victim_coll: str,
                   aggr_coll: str, sizes: Sequence[float],
                   profiles: Sequence[cong.Profile], *, n_iters: int = 60,
                   warmup: int = 10, dt: Optional[float] = None,
                   max_steps: int = 200_000, chunk: int = 2048,
                   trace_stride: int = 8, phased: bool = False,
                   jobs: Optional[Sequence[traffic.JobSpec]] = None,
                   device=None, core: Optional[str] = None, mesh=None,
                   launcher=None) -> List[BenchResult]:
    """A whole cross-scale experiment, heterogeneous ``(system,
    n_nodes)`` cells x (vector size x profile), in one batched run over
    one geometry bucket. Padding is inert (simulator.pad_geometry): a
    padded cell runs bit for bit as it runs alone. Results come back in
    input order: cells major, then sizes, then baseline/profiles (a
    per-cell :func:`run_grid` concatenation). ``mesh``/``launcher`` shard
    the run across devices (launch/sweep.py), bit-identical to the
    single-device run."""
    return launch_scale_grid(cells, victim_coll, aggr_coll, sizes, profiles,
                             n_iters=n_iters, warmup=warmup, dt=dt,
                             max_steps=max_steps, chunk=chunk,
                             trace_stride=trace_stride, phased=phased,
                             jobs=jobs, device=device, core=core,
                             mesh=mesh, launcher=launcher).results()


def run_point(system: SystemPreset, n_nodes: int, victim_coll: str,
              aggr_coll: str, vector_bytes: float,
              profile: cong.Profile, *, n_iters: int = 60, warmup: int = 10,
              dt: Optional[float] = None, max_steps: int = 200_000,
              return_traces: bool = False, phased: bool = False,
              jobs: Optional[Sequence[traffic.JobSpec]] = None,
              seed: int = 7, device=None, core: Optional[str] = None):
    """One heatmap cell: baseline (aggressors off) vs congested run,
    batched as a 2-cell grid. ``seed`` picks the allocation draw."""
    device = resolve_device(device)
    check_iter_budget(n_iters)
    with_ft = cong.needs_fault_table([profile])
    case = build_case(system, n_nodes, victim_coll, aggr_coll,
                      phased=phased, jobs=jobs, seed=seed,
                      intra_node=profile.node_cap_frac > 0)
    lat = case.lat()
    if dt is None:
        dt = choose_dt(case.topo, case.n_victims, vector_bytes, lat,
                       n_phases=case.max_phases)
    chunk, stride = 2048, 8
    params = stack_params([
        case.cell_params(vector_bytes, cong.no_congestion(), dt,
                         with_fault_table=with_ft),
        case.cell_params(vector_bytes, profile, dt,
                         with_fault_table=with_ft)])
    out = run_cells(case.geom, params, n_iters, chunk=chunk,
                    max_chunks=-(-max_steps // chunk), stride=stride,
                    device=device, core=core)
    base = summarize(out, n_iters=n_iters, warmup=warmup, dt=dt, chunk=chunk,
                     stride=stride, cell=0)
    cong_res = summarize(out, n_iters=n_iters, warmup=warmup, dt=dt,
                         chunk=chunk, stride=stride, cell=1)
    res = _result(case, out, base, cong_res, profile=profile.kind,
                  vector_bytes=vector_bytes, n_iters=n_iters,
                  warmup=warmup, cell=1)
    if return_traces:
        return res, base, cong_res
    return res


# --------------------------------------------------------------------------
# Single-trace helpers
# --------------------------------------------------------------------------


def goodput_case(system: SystemPreset, n_nodes: int, coll: str,
                 vector_bytes: float, *, dt: float = 20e-6):
    """The geometry and one-cell parameters of a self-congestion run:
    ``coll`` on all ``n_nodes`` allocated nodes, no aggressors."""
    topo = machine_topology(system) if system.machine_nodes \
        else system.make_topology(n_nodes)
    nodes = allocate(system, n_nodes)
    flows = cong.build_flowset(topo, nodes, [], coll, "", vector_bytes,
                               routing_mode=system.static_routing,
                               k_max=system.k_max)
    params = make_params(system.cc, dt=dt,
                         bytes_per_iter=flows.bytes_per_iter,
                         host_caps=flows.host_caps,
                         env=cong.no_congestion().params(),
                         policy=default_policy(system))
    return make_geometry(topo, flows), params


def goodput_inputs(points: Sequence[Tuple[SystemPreset, int, str, float]],
                   *, dt: float = 20e-6):
    """What :func:`goodput_traces` runs: the points' geometries padded
    into one bucket (:func:`bucket_stack`) and their params, one cell
    each, with (point, 1) leading axes; the per-flow fields of a point
    with fewer flows than the bucket padded with 0 bytes and a cap of 1.
    Returns ``(stacked, params)``."""
    cases = [goodput_case(s, n, c, v, dt=dt) for s, n, c, v in points]
    dims, stacked = bucket_stack([geom for geom, _ in cases])

    def pad(p: SimParams) -> SimParams:
        extra = dims.n_flows - p.bytes_per_iter.shape[-1]
        return dataclasses.replace(
            p, bytes_per_iter=torch.nn.functional.pad(p.bytes_per_iter,
                                                      (0, extra)),
            host_caps=torch.nn.functional.pad(p.host_caps, (0, extra),
                                              value=1.0))
    return stacked, stack_params([stack_params([pad(p)]) for _, p in cases])


def goodput_traces(points: Sequence[Tuple[SystemPreset, int, str, float]],
                   *, n_iters: int = 40, dt: float = 20e-6,
                   max_steps: int = 200_000, device=None) -> List:
    """Self-congestion runs (no aggressors; the Fig. 3 sawtooth
    experiments) of ``(system, n_nodes, coll, vector_bytes)`` points as
    one batch (:func:`goodput_inputs`), every step one launch of each
    kernel for all of them. A padded cell runs bit for bit as it runs
    alone (:func:`goodput_case` through simulator.run_cell). One
    SimResult a point, in input order."""
    device = resolve_device(device)
    check_iter_budget(n_iters)
    stacked, params = goodput_inputs(points, dt=dt)
    chunk, stride = 2048, 8
    out = run_cells_hetero(stacked, params, n_iters, chunk=chunk,
                           max_chunks=-(-max_steps // chunk), stride=stride,
                           device=device)
    return [summarize(out, n_iters=n_iters, warmup=5, dt=dt, chunk=chunk,
                      stride=stride, cell=(k, 0)) for k in range(len(points))]
