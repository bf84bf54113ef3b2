"""Seeded stochastic fleet workloads, replayed as one batch of seeds.

The paper's motivation is congestion driven by "heterogeneous traffic
patterns resulting from diverse workload mixes"; fleet telemetry studies
characterize it as distributions over thousands of arrival patterns,
not single hand-scripted job sets. This module lowers a stochastic
workload model into the batched engine so thousands of seeds replay as
one batch, every engine step one launch of each kernel for all of them:

* **Template (host side, per workload config).** The structure of the
  workload is fixed: long-lived training tenants (phased ring / AlltoAll
  programs with compute gaps, through the JobSpec compiler) plus
  :attr:`WorkloadSpec.short_slots` short-flow rows appended to the
  program, each slot a (src, dst) pair drawn once from the allocation
  with the splitmix64 template stream. Paths, NIC caps and the geometry
  are bound once and shared by every seed.

* **Per-seed lowering.** :func:`lower_seeds` draws, from each seed alone
  and with JAX's Threefry bits (core/prng.py, so a seed draws what it
  draws in the reference, and the same alone or in any batch): which
  slots fire (Bernoulli thinning at rate
  ``arrivals_mean / short_slots``, the binomial construction of a Poisson
  count), their arrival times (uniform over the horizon), their sizes
  (lognormal, optionally mixed with a bounded Pareto tail), a CC kind per
  job from :attr:`WorkloadSpec.cc_mix`, and a tenant start stagger. All
  of it lands in per-flow SimParams fields (``bytes_per_iter``,
  ``flow_start``, ``fct_mask``, ``kind``); the seeds are a leading axis of
  every draw, not a Python loop.

An idle slot carries 0 bytes, so it is never ``alive`` and stays inert,
as a geometry's pad flows are. The shorts job's phase gap is
:data:`SHORT_GAP_NEVER`, so a drained slot never re-arms.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import bench, congestion as cong, prng, traffic
from repro_torch.core.fabric import cc as cc_lib
from repro_torch.core.fabric import simulator as sim
from repro_torch.core.fabric import systems
from repro_torch.core.fabric.routing import splitmix64

# a phase gap no replay horizon ever reaches: short-flow slots are
# one-shot (their job's single phase never advances)
SHORT_GAP_NEVER = 1e9

_CC_KINDS = {"dcqcn": cc_lib.KIND_DCQCN, "ib": cc_lib.KIND_IB,
             "slingshot": cc_lib.KIND_SLINGSHOT,
             "ai_ecn": cc_lib.KIND_AI_ECN}


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One stochastic fleet-workload configuration (the template knobs;
    everything a seed varies is drawn by :func:`lower_seeds`)."""

    system: str = "lumi"
    n_nodes: int = 32
    # long-lived training tenants: one phased job per collective listed
    tenant_collectives: Tuple[str, ...] = ("ring_allreduce", "alltoall")
    tenant_bytes: float = float(1 << 20)
    tenant_gap_s: float = 100e-6  # compute gap between schedule phases
    tenant_stagger_s: float = 500e-6  # per-seed uniform start offset
    # Poisson short flows: S padded slots, each active with probability
    # arrivals_mean / short_slots
    short_slots: int = 64
    arrivals_mean: float = 24.0
    horizon_s: float = 0.02  # arrival window (simulated seconds)
    short_bytes_median: float = float(256 << 10)
    short_sigma: float = 1.2  # lognormal shape (natural-log std)
    # heavy-tailed size mix: this fraction of short slots draws from a
    # bounded Pareto (inverse CDF) instead of the lognormal; 0.0 consumes
    # none of the Pareto keys
    short_pareto_frac: float = 0.0
    short_pareto_alpha: float = 1.3  # tail index (smaller = heavier)
    short_pareto_min: float = float(64 << 10)
    short_pareto_max: float = float(64 << 20)
    # per-job CC mix: (name, probability)
    cc_mix: Tuple[Tuple[str, float], ...] = (
        ("dcqcn", 0.5), ("ib", 0.25), ("slingshot", 0.25))
    template_seed: int = 0

    def __post_init__(self):
        if self.short_slots < 1:
            raise ValueError("short_slots must be >= 1")
        if not 0.0 <= self.short_pareto_frac <= 1.0:
            raise ValueError("short_pareto_frac must be in [0, 1]")
        if self.short_pareto_frac > 0:
            if self.short_pareto_alpha <= 0:
                raise ValueError("short_pareto_alpha must be > 0")
            if not 0 < self.short_pareto_min < self.short_pareto_max:
                raise ValueError("need 0 < short_pareto_min "
                                 "< short_pareto_max")
        if not self.cc_mix:
            raise ValueError("cc_mix must not be empty")
        for name, _ in self.cc_mix:
            if name not in _CC_KINDS:
                raise KeyError(f"unknown CC kind {name!r}; expected one "
                               f"of {sorted(_CC_KINDS)}")


@dataclasses.dataclass
class ReplayTemplate:
    """Host-built, seed-independent replay structure: the bound geometry
    plus the per-flow base tables :func:`lower_seeds` overlays."""

    spec: WorkloadSpec
    geom: sim.FabricGeometry
    dt: float
    policy: int
    cc: cc_lib.CCParams  # scalar CC knobs (kind is drawn per seed)
    env: np.ndarray  # envelope components (steady; tenants self-gate)
    base_bytes: np.ndarray  # (F,) tenant bytes; short/pad rows 0
    host_caps: np.ndarray  # (F,)
    fct_mask: np.ndarray  # (F,) 1.0 on short rows
    flow_job: np.ndarray  # (F,) incl. pad rows
    job_is_tenant: np.ndarray  # (J,)
    short_idx: np.ndarray  # (S,) row indices of the short slots
    n_jobs: int  # incl. pad jobs (grows under pad_template)
    # real jobs (tenants + shorts): job-level draws use this count, so
    # bucket padding cannot change a seed's draws
    n_real_jobs: int
    job_names: Tuple[str, ...]
    mix_kinds: np.ndarray  # (M,) kind id per mix entry
    mix_logp: np.ndarray  # (M,) float32 log-probabilities

    @property
    def n_flows(self) -> int:
        return int(self.geom.n_flows)


def _short_endpoints(nodes: np.ndarray, n_slots: int,
                     template_seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(src, dst) per slot, distinct by construction, from the splitmix64
    template stream."""
    n = len(nodes)
    slot = np.arange(n_slots, dtype=np.uint64)
    h1 = splitmix64(slot ^ (np.uint64(template_seed) << np.uint64(32)))
    h2 = splitmix64(h1)
    si = (h1 % np.uint64(n)).astype(np.int64)
    off = 1 + (h2 % np.uint64(max(n - 1, 1))).astype(np.int64)
    return nodes[si], nodes[(si + off) % n]


def build_template(spec: WorkloadSpec,
                   pad_to: Optional[Tuple[int, int, int]] = None
                   ) -> ReplayTemplate:
    """Compile the tenant programs, append the short-flow slots, bind to
    the system topology (on the CPU). ``pad_to=(n_flows, n_jobs,
    n_phases)`` pads the program to bucket dims (inert rows)."""
    sysp = systems.get_system(spec.system)
    topo = bench.machine_topology(sysp, spec.n_nodes)
    nodes = bench.allocate(sysp, spec.n_nodes, seed=7 + spec.template_seed)
    jobs = [traffic.JobSpec(f"tenant{i}_{coll}", coll,
                            vector_bytes=spec.tenant_bytes, phased=True,
                            gap_s=spec.tenant_gap_s, sweep_bytes=False)
            for i, coll in enumerate(spec.tenant_collectives)]
    jobs = traffic.split_nodes(nodes, jobs)
    prog = traffic.compile_programs(jobs, validate=True)

    # the short-flow job, its rows assembled by hand (the JobSpec compiler
    # knows collectives only)
    S = spec.short_slots
    s_src, s_dst = _short_endpoints(np.asarray(nodes), S,
                                    spec.template_seed)
    jt = prog.n_jobs  # shorts job id
    p_max = int(prog.phase_gap.shape[1])
    phase_gap = np.zeros((jt + 1, p_max), np.float32)
    phase_gap[:jt] = prog.phase_gap
    phase_gap[jt, 0] = SHORT_GAP_NEVER
    prog = traffic.TrafficProgram(
        jobs=prog.jobs + (traffic.JobSpec("shorts", "shortflows",
                                          sweep_bytes=False),),
        src=np.concatenate([prog.src, s_src.astype(np.int32)]),
        dst=np.concatenate([prog.dst, s_dst.astype(np.int32)]),
        bytes_per_phase=np.concatenate(
            [prog.bytes_per_phase,
             np.full((S,), spec.short_bytes_median)]),
        flow_job=np.concatenate(
            [prog.flow_job, np.full((S,), jt, np.int32)]),
        flow_phase=np.concatenate([prog.flow_phase,
                                   np.zeros((S,), np.int32)]),
        n_phases=np.concatenate([prog.n_phases, [1]]).astype(np.int32),
        phase_gap=phase_gap,
        env_gated=np.concatenate([prog.env_gated, [False]]),
        sweep_mask=np.concatenate([prog.sweep_mask,
                                   np.zeros((S,), bool)]))
    traffic.check_program(prog)  # tenants still conserve wire bytes
    if pad_to is not None:
        prog = traffic.pad_program(prog, n_flows=pad_to[0],
                                   n_jobs=pad_to[1], n_phases=pad_to[2])

    flows = cong.bind_program(topo, prog,
                              routing_mode=sysp.static_routing,
                              k_max=sysp.k_max, seed=spec.template_seed)
    geom = sim.make_geometry(topo, flows)

    n0 = len(jobs[0].nodes)
    dt = bench.choose_dt(topo, n0, spec.tenant_bytes,
                         cong.latency_model(spec.tenant_collectives[0], n0),
                         int(prog.n_phases.max()))

    fjob = np.asarray(prog.flow_job)
    short_mask = fjob == jt
    base_bytes = np.where(short_mask, 0.0,
                          prog.bytes_per_phase).astype(np.float32)
    n_jobs = len(prog.n_phases)
    job_is_tenant = np.zeros((n_jobs,), np.float32)
    job_is_tenant[:jt] = 1.0
    names = tuple(j.name for j in prog.jobs) + tuple(
        traffic.PAD_JOB_NAME for _ in range(n_jobs - len(prog.jobs)))
    mix_names = [m for m, _ in spec.cc_mix]
    mix_p = np.asarray([p for _, p in spec.cc_mix], np.float64)
    mix_p = mix_p / mix_p.sum()
    return ReplayTemplate(
        spec=spec, geom=geom, dt=float(dt),
        policy=int(systems.default_policy(sysp)),
        cc=sysp.cc, env=cong.steady().params(),
        base_bytes=base_bytes,
        host_caps=np.asarray(flows.host_caps, np.float32),
        fct_mask=short_mask.astype(np.float32),
        flow_job=fjob.astype(np.int32),
        job_is_tenant=job_is_tenant,
        short_idx=np.nonzero(short_mask)[0].astype(np.int32),
        n_jobs=n_jobs, n_real_jobs=jt + 1, job_names=names,
        mix_kinds=np.asarray([_CC_KINDS[m] for m in mix_names], np.int32),
        mix_logp=np.log(mix_p).astype(np.float32))


def pad_template(t: ReplayTemplate,
                 dims: sim.GeometryDims) -> ReplayTemplate:
    """Pad a template to bucket dims so templates of different systems
    stack (as bench.bucket_stack pads geometries)."""
    F, J = dims.n_flows, dims.n_jobs
    pad = traffic.pad_rows
    return dataclasses.replace(
        t, geom=sim.pad_geometry(t.geom, dims),
        base_bytes=pad(t.base_bytes, F, 0.0),
        host_caps=pad(t.host_caps, F, 1.0),
        fct_mask=pad(t.fct_mask, F, 0.0),
        flow_job=pad(t.flow_job, F, J - 1),
        job_is_tenant=pad(t.job_is_tenant, J, 0.0),
        n_jobs=J,
        job_names=t.job_names + tuple(
            traffic.PAD_JOB_NAME for _ in range(J - len(t.job_names))))


# --------------------------------------------------------------------------
# Per-seed lowering, batched over seeds
# --------------------------------------------------------------------------


def lower_seeds(t: ReplayTemplate, seeds, device=None) -> sim.SimParams:
    """SimParams with a leading seed axis, each seed's draws those of
    ``jax.random`` for ``PRNGKey(seed)`` in the reference's
    ``lower_seed``: the same keys, the same bits, the same float recipes.
    A seed lowers the same alone or in any batch. On ``device`` (default:
    the CUDA device)."""
    dev = sim.resolve_device(device)
    spec = t.spec
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    N, S = len(seeds), spec.short_slots
    f32 = dict(dtype=torch.float32, device=dev)
    key = prng.key(torch.as_tensor(seeds, device=dev))
    k_act, k_size, k_time, k_cc, k_st = prng.split(key, 5).unbind(-2)
    # Poisson arrivals via slot thinning + order-statistics times
    active = prng.bernoulli(k_act, min(spec.arrivals_mean / S, 1.0), (S,))
    sizes = spec.short_bytes_median * prng.f32(
        torch.exp, spec.short_sigma * prng.normal(k_size, (S,)))
    if spec.short_pareto_frac > 0:
        # bounded Pareto by inverse CDF, x = xm (1 - U (1 - (xm/xM)^a))
        # ^(-1/a) in [xm, xM], from keys folded off the seed's key, so
        # the five-way split (and every draw of frac = 0) is untouched
        k_mix, k_par = prng.split(prng.fold_in(key, 1), 2).unbind(-2)
        a = spec.short_pareto_alpha
        ratio = (spec.short_pareto_min / spec.short_pareto_max) ** a
        u = prng.uniform(k_par, (S,))
        pareto = spec.short_pareto_min * prng.f32(
            lambda b: b ** (-1.0 / a), 1.0 - u * (1.0 - ratio))
        heavy = prng.bernoulli(k_mix, spec.short_pareto_frac, (S,))
        sizes = torch.where(heavy, pareto, sizes)
    starts = prng.uniform(k_time, (S,), 0.0, spec.horizon_s)
    short_bytes = torch.where(active, sizes, 0.0).to(torch.float32)
    # per-job CC kind from the mix, drawn over the real jobs only; pad
    # jobs take the first kind and no stagger (inert either way)
    nr, n_pad = t.n_real_jobs, t.n_jobs - t.n_real_jobs
    mix_idx = prng.categorical(k_cc, torch.as_tensor(t.mix_logp), (nr,))
    kinds = torch.as_tensor(t.mix_kinds, dtype=torch.int64, device=dev)
    job_kind = torch.cat([kinds[mix_idx],
                          kinds[:1].expand(N, n_pad)], 1)
    fjob = torch.as_tensor(t.flow_job, dtype=torch.int64, device=dev)
    flow_kind = job_kind[:, fjob]
    job_start = prng.uniform(k_st, (nr,), 0.0,
                             max(spec.tenant_stagger_s, 1e-12))
    is_tenant = torch.as_tensor(t.job_is_tenant, **f32)
    job_start = torch.cat([job_start, torch.zeros((N, n_pad), **f32)], 1) \
        * is_tenant
    sidx = torch.as_tensor(t.short_idx, dtype=torch.int64, device=dev)
    flow_start = is_tenant[fjob] * job_start[:, fjob]
    flow_start[:, sidx] = starts
    bpi = torch.as_tensor(t.base_bytes, **f32).repeat(N, 1)
    bpi[:, sidx] = short_bytes
    one = sim.make_params(t.cc, dt=t.dt, bytes_per_iter=t.base_bytes,
                          host_caps=t.host_caps, env=t.env, policy=t.policy,
                          fct_mask=t.fct_mask).to(dev)
    per_seed = {"bytes_per_iter": bpi, "flow_start": flow_start,
                "kind": flow_kind}
    return sim.SimParams(**{
        k: per_seed[k] if k in per_seed
        else None if getattr(one, k) is None
        else getattr(one, k).expand(N, *getattr(one, k).shape).clone()
        for k in sim.PARAM_FIELDS})


def replay_budget(t: ReplayTemplate, chunk: int = 2048,
                  tail_frac: float = 0.5) -> int:
    """Chunk budget covering the arrival horizon plus a drain tail (late
    arrivals need time to complete)."""
    steps = (1.0 + tail_frac) * t.spec.horizon_s / t.dt
    return max(int(np.ceil(steps / chunk)), 1)


def replay_inputs(templates: Sequence[ReplayTemplate], seeds, device=None):
    """What :func:`run_replay` runs: the templates padded into one bucket
    (bench.bucket_stack), their stacked geometries, and ``seeds`` lowered
    on each padded template, params with (template, seed) leading axes on
    ``device``. Returns ``(padded, geometries, params)``."""
    device = sim.resolve_device(device)
    dims, geoms = bench.bucket_stack([t.geom for t in templates])
    padded = [pad_template(t, dims) for t in templates]
    params = sim.stack_params([lower_seeds(t, seeds, device)
                               for t in padded])
    return padded, geoms, params


def run_replay(templates: Sequence[ReplayTemplate], seeds, *,
               chunk: int = 2048, metrics: bool = True,
               with_trace: bool = False, device=None, launcher=None,
               mesh=None):
    """Replay ``seeds`` over one or more templates in ONE batched run:
    geometries pad into one bucket and stack (bench.bucket_stack), params
    get a (template, seed) leading pair, the streaming metrics ride the
    state; each engine step is one launch of kernel 1 for every (template,
    seed) cell. On ``device`` (default: the CUDA device), or split across
    devices by a ``launcher`` or a ``mesh`` (launch/sweep.py); the seeds
    are lowered on ``device``, by default the mesh's first. Returns
    ``(out, padded_templates)``."""
    if device is None and mesh is not None:
        device = sim.mesh_devices(mesh)[0]
    device = sim.resolve_device(device)
    padded, geoms, params = replay_inputs(templates, seeds, device)
    max_chunks = max(replay_budget(t, chunk) for t in padded)
    kw = dict(chunk=chunk, max_chunks=max_chunks, stride=8, metrics=metrics,
              with_trace=with_trace)
    if launcher is not None:
        out = launcher(geoms, params, sim.TDONE_SLOTS, **kw)
    else:
        out = sim.run_cells_hetero(geoms, params, sim.TDONE_SLOTS,
                                   device=device, mesh=mesh, **kw)
    return out, padded


# --------------------------------------------------------------------------
# Host-side summary
# --------------------------------------------------------------------------


def tenant_bytes(out_fbytes: np.ndarray, t: ReplayTemplate) -> np.ndarray:
    """Per-job delivered bytes (..., J) from per-flow accumulators."""
    fb = np.asarray(out_fbytes)
    J = t.n_jobs
    res = np.zeros(fb.shape[:-1] + (J,), np.float64)
    for j in range(J):
        m = t.flow_job == j
        if m.any():
            res[..., j] = fb[..., m].sum(-1)
    return res


def summarize_replay(out, padded: Sequence[ReplayTemplate],
                     qs=None) -> list:
    """One summary dict per template: aggregate percentiles, per-job
    slowdown statistics and delivered bytes. Host-side NumPy over the
    O(B x bins) outputs only."""
    from repro_torch.core import metrics as met

    qs = qs or met.QUANTILES
    res = []
    for k, t in enumerate(padded):
        h_qd = np.asarray(out["h_qd"])[k]  # (B, NBINS)
        h_fct = np.asarray(out["h_fct"])[k]
        agg_qd = met.percentiles(h_qd.sum(0), qs)
        agg_fct = met.percentiles(h_fct.sum(0), qs)
        wn_k = np.asarray(out["wn"])[k]
        wmean_k = np.asarray(out["wmean"])[k]
        wn, wmean, wstd = met.welford_finalize(
            wn_k.sum(0),
            # merged mean across seeds: per-seed means weighted by counts
            _wmerge_mean(wn_k, wmean_k),
            _wmerge_m2(wn_k, wmean_k, np.asarray(out["wm2"])[k]))
        jobs = {}
        tb = tenant_bytes(out["fbytes"], t)
        for j, name in enumerate(t.job_names):
            if name == traffic.PAD_JOB_NAME:
                continue
            jobs[name] = {
                "completions": float(wn[j]),
                "slowdown_mean": float(wmean[j]),
                "slowdown_std": float(wstd[j]),
                "bytes_mean": float(tb[k, :, j].mean()),
            }
        res.append({
            "system": t.spec.system, "n_nodes": t.spec.n_nodes,
            "dt_s": t.dt,
            "qdelay_s": {str(q): float(v) for q, v in agg_qd.items()},
            "fct_s": {str(q): float(v) for q, v in agg_fct.items()},
            "fct_samples": float(h_fct.sum()),
            "qdelay_samples": float(h_qd.sum()),
            "jobs": jobs,
        })
    return res


def _wmerge_mean(wn, wmean):
    tot = np.maximum(wn.sum(0), 1.0)
    return (wn * wmean).sum(0) / tot


def _wmerge_m2(wn, wmean, wm2):
    """Chan merge of per-seed accumulators into one (host side)."""
    tot = np.maximum(wn.sum(0), 1.0)
    gmean = (wn * wmean).sum(0) / tot
    return wm2.sum(0) + (wn * (wmean - gmean) ** 2).sum(0)
