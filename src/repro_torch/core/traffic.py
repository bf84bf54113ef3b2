"""Traffic-program IR: collective schedules compiled to phase programs.

The paper's central claim is that congestion impact depends on the
*temporal structure* of traffic, not just its aggregate volume: a ring
AllReduce is 2(n-1) barrier-synchronized neighbor exchanges, a pairwise
AlltoAll is n-1 disjoint pairings, an incast is a serialized fan-in — and
each stresses the fabric differently from a flattened "all flows at once"
blob. This module is the IR between the schedule definitions
(collectives.py) and the fluid simulator:

* A :class:`JobSpec` names one tenant: a node set, a collective kind, a
  vector size, and how its schedule is lowered (``phased`` step-by-step
  vs flattened, optional per-phase compute gap, envelope gating for
  aggressor-style jobs, ``endless`` background loops).
* :func:`compile_phases` lowers one job to a list of :class:`PhaseSpec`
  — each a set of (src, dst, bytes) flows plus a compute-gap duration —
  using the same schedules collectives.py executes on device: ring
  AllGather step k sends shard r-k along the ring, pairwise AlltoAll
  step k pairs rank r with r^k (r+k for non-power-of-two n), incast
  fans in one source per step.
* :func:`compile_programs` packs any number of jobs into one
  :class:`TrafficProgram`: flat per-flow arrays (src, dst, bytes, job id,
  phase id) plus per-job phase tables (phase count, per-phase gaps) with
  fixed shapes, so the whole multi-job mix runs as one batched engine
  run (simulator.py executes the program; phase advance is barrier-gated
  on the slowest member flow, preserving DESIGN.md §7 straggler
  semantics).

Every compiled program is validated against the analytic
``collectives.wire_bytes_model``: per-rank bytes summed over phases and
the serialized step count must match the model exactly (:func:`check_program`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.collectives import wire_bytes_model

# Endless background loop (paper §III-A: aggressors loop "endlessly").
ENDLESS_BYTES = 1e30

# flow_phase sentinel: the flow is a member of EVERY phase of its job
# (uniform schedules — e.g. ring steps reuse the same n neighbor edges —
# store one flow row per edge instead of one per (phase, edge))
WILDCARD_PHASE = -1

# collective kind (congestion.py naming) -> wire_bytes_model kind
WIRE_KIND = {
    "ring_allgather": "ring_all_gather",
    "ring_allreduce": "ring_all_reduce",
    "alltoall": "linear_all_to_all",
    "pairwise_alltoall": "pairwise_all_to_all",
    "incast": "incast",
}


@dataclasses.dataclass(frozen=True)
class PhaseSpec:
    """One schedule step: flows that transmit concurrently, then a
    compute gap before the job's barrier releases the next phase."""

    flows: Tuple[Tuple[int, int, float], ...]  # (src, dst, bytes)
    gap_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One tenant's traffic program, declaratively.

    ``nodes=None`` lets case construction fill in an interleaved share of
    the allocation (:func:`split_nodes`). ``sweep_bytes`` marks the job's
    bytes as linear in the swept vector size (bench grids); background
    jobs keep their own fixed volume. ``endless`` collapses the schedule
    to a single never-completing phase (the paper's aggressor loop), and
    ``envelope_gated`` subjects injection to the congestion envelope.
    """

    name: str
    collective: str
    vector_bytes: float = 1.0
    nodes: Optional[Tuple[int, ...]] = None
    phased: bool = True
    gap_s: float = 0.0
    envelope_gated: bool = False
    endless: bool = False
    sweep_bytes: bool = True

    def with_nodes(self, nodes) -> "JobSpec":
        return dataclasses.replace(self, nodes=tuple(int(x) for x in nodes))


@dataclasses.dataclass
class TrafficProgram:
    """Packed multi-job flow program (the simulator's static input).

    Flow arrays are flat over every (job, phase, flow); per-job tables
    are padded to the longest program so every cell has one shape.
    """

    jobs: Tuple[JobSpec, ...]
    src: np.ndarray  # (F,) int32
    dst: np.ndarray  # (F,) int32
    bytes_per_phase: np.ndarray  # (F,) float64
    flow_job: np.ndarray  # (F,) int32
    flow_phase: np.ndarray  # (F,) int32
    n_phases: np.ndarray  # (J,) int32
    phase_gap: np.ndarray  # (J, P_max) float32
    env_gated: np.ndarray  # (J,) bool
    sweep_mask: np.ndarray  # (F,) bool — bytes scale with swept size

    @property
    def n_jobs(self) -> int:
        return len(self.jobs)

    @property
    def n_flows(self) -> int:
        return len(self.src)

    def job_names(self) -> List[str]:
        return [j.name for j in self.jobs]


# --------------------------------------------------------------------------
# Schedule lowering (mirrors collectives.py step for step)
# --------------------------------------------------------------------------


def _flat_flows(nodes: Sequence[int], kind: str,
                v: float) -> List[Tuple[int, int, float]]:
    """Flattened (single-phase) flow set of one collective."""
    nodes = list(nodes)
    n = len(nodes)
    if n < 2:
        return []
    out: List[Tuple[int, int, float]] = []
    if kind == "ring_allgather":
        per = v * (n - 1) / n
        out = [(nodes[i], nodes[(i + 1) % n], per) for i in range(n)]
    elif kind == "ring_allreduce":
        per = 2.0 * v * (n - 1) / n
        out = [(nodes[i], nodes[(i + 1) % n], per) for i in range(n)]
    elif kind in ("alltoall", "pairwise_alltoall"):
        per = v / n
        out = [(i, j, per) for i in nodes for j in nodes if i != j]
    elif kind == "incast":
        out = [(i, nodes[0], v) for i in nodes[1:]]
    else:
        raise KeyError(kind)
    return out


def _ring_phases(nodes: Sequence[int], v: float, steps: int) -> List[Tuple]:
    """``steps`` barrier-gated ring exchanges of one V/n shard each
    (AllGather: n-1 steps; AllReduce: 2(n-1) = ReduceScatter + AllGather).
    Step k of the AG half moves the shard of rank r-k to the ring
    neighbor — the shard *identity* rotates but the wire pattern is the
    same n neighbor flows every step, which is exactly what the fluid
    model sees."""
    nodes = list(nodes)
    n = len(nodes)
    per = v / n
    ring = [(nodes[i], nodes[(i + 1) % n], per) for i in range(n)]
    return [tuple(ring) for _ in range(steps)]


def _pairwise_phases(nodes: Sequence[int], v: float) -> List[Tuple]:
    """n-1 phases; phase k pairs rank r with r XOR k when n is a power of
    two (disjoint transpositions — each step is a perfect matching), else
    with r+k mod n (the shifted-exchange schedule of
    collectives.pairwise_all_to_all)."""
    nodes = list(nodes)
    n = len(nodes)
    per = v / n
    phases = []
    pow2 = n & (n - 1) == 0
    for k in range(1, n):
        if pow2:
            flows = [(nodes[i], nodes[i ^ k], per) for i in range(n)]
        else:
            flows = [(nodes[i], nodes[(i + k) % n], per) for i in range(n)]
        phases.append(tuple(flows))
    return phases


def _incast_phases(nodes: Sequence[int], v: float) -> List[Tuple]:
    """Serialized fan-in: one source per phase sends its full vector to
    the root (wire_bytes_model counts incast as n-1 serialized steps)."""
    nodes = list(nodes)
    return [((nodes[k], nodes[0], v),) for k in range(1, len(nodes))]


def compile_phases(kind: str, nodes: Sequence[int], vector_bytes: float,
                   *, phased: bool = True,
                   gap_s: float = 0.0) -> List[PhaseSpec]:
    """Lower one collective to its phase list. ``phased=False`` flattens
    the schedule into a single phase carrying the full per-iteration
    volume (the pre-IR simulator behavior, kept as the baseline shape)."""
    n = len(list(nodes))
    if n < 2:
        return []
    if not phased:
        return [PhaseSpec(tuple(_flat_flows(nodes, kind, vector_bytes)),
                          gap_s)]
    if kind == "ring_allgather":
        phases = _ring_phases(nodes, vector_bytes, n - 1)
    elif kind == "ring_allreduce":
        # 2(n-1) shard-sized steps (ReduceScatter + AllGather); the 2x
        # wire volume comes from the doubled step count, not the shard
        phases = _ring_phases(nodes, vector_bytes, 2 * (n - 1))
    elif kind in ("alltoall", "pairwise_alltoall"):
        phases = _pairwise_phases(nodes, vector_bytes)
    elif kind == "incast":
        phases = _incast_phases(nodes, vector_bytes)
    else:
        raise KeyError(kind)
    return [PhaseSpec(fl, gap_s) for fl in phases]


def compile_job(job: JobSpec) -> List[PhaseSpec]:
    """Lower one job. Endless jobs become a single phase whose flows
    never drain (the paper's aggressor loop); the envelope then shapes
    their injection over time."""
    if job.nodes is None:
        raise ValueError(f"job {job.name!r} has no node assignment")
    if job.endless:
        flows = tuple((s, d, ENDLESS_BYTES)
                      for s, d, _ in _flat_flows(job.nodes, job.collective,
                                                 1.0))
        return [PhaseSpec(flows, 0.0)] if flows else []
    return compile_phases(job.collective, job.nodes, job.vector_bytes,
                          phased=job.phased, gap_s=job.gap_s)


# --------------------------------------------------------------------------
# Packing + validation
# --------------------------------------------------------------------------


def compile_programs(jobs: Sequence[JobSpec],
                     validate: bool = True) -> TrafficProgram:
    """Pack jobs into one flat program (and validate non-endless jobs
    against the analytic wire-byte model)."""
    jobs = tuple(jobs)
    if not jobs:
        raise ValueError("no jobs")
    per_job = [compile_job(j) for j in jobs]
    for job, phases in zip(jobs, per_job):
        if not any(ph.flows for ph in phases):
            raise ValueError(
                f"job {job.name!r} ({job.collective} on "
                f"{len(job.nodes or ())} nodes) lowers to zero flows — "
                "every job needs at least 2 nodes; use a larger "
                "allocation or fewer tenants")
    src, dst, byt, fjob, fphase = [], [], [], [], []
    n_phases = np.ones((len(jobs),), np.int32)
    p_max = max((len(ph) for ph in per_job), default=1) or 1
    phase_gap = np.zeros((len(jobs), p_max), np.float32)
    for ji, phases in enumerate(per_job):
        n_phases[ji] = max(len(phases), 1)
        for pi, phase in enumerate(phases):
            phase_gap[ji, pi] = phase.gap_s
        if len(phases) > 1 and all(ph.flows == phases[0].flows
                                   for ph in phases):
            # uniform schedule (ring steps): one wildcard row per edge,
            # re-armed at every phase entry, instead of n_phases copies
            phases = [PhaseSpec(phases[0].flows)]
            pids = [WILDCARD_PHASE]
        else:
            pids = list(range(len(phases)))
        for pi, phase in zip(pids, phases):
            for (s, d, b) in phase.flows:
                src.append(s)
                dst.append(d)
                byt.append(b)
                fjob.append(ji)
                fphase.append(pi)
    prog = TrafficProgram(
        jobs=jobs,
        src=np.asarray(src, np.int32), dst=np.asarray(dst, np.int32),
        bytes_per_phase=np.asarray(byt, np.float64),
        flow_job=np.asarray(fjob, np.int32),
        flow_phase=np.asarray(fphase, np.int32),
        n_phases=n_phases, phase_gap=phase_gap,
        env_gated=np.array([j.envelope_gated for j in jobs]),
        sweep_mask=np.array([jobs[j].sweep_bytes and not jobs[j].endless
                             for j in fjob], bool)
        if fjob else np.zeros((0,), bool))
    if validate:
        check_program(prog)
    return prog


def job_wire_stats(prog: TrafficProgram, ji: int) -> Dict[str, float]:
    """Observed (max per-rank bytes, serialized steps) for job ``ji``.
    A wildcard flow transmits its bytes once per phase."""
    mask = prog.flow_job == ji
    steps = int(prog.n_phases[ji])
    per_rank: Dict[int, float] = {}
    for s, p, b in zip(prog.src[mask], prog.flow_phase[mask],
                       prog.bytes_per_phase[mask]):
        mult = steps if p == WILDCARD_PHASE else 1
        per_rank[int(s)] = per_rank.get(int(s), 0.0) + float(b) * mult
    return {"bytes": max(per_rank.values(), default=0.0), "steps": steps}


def check_program(prog: TrafficProgram) -> None:
    """Phased programs must conserve the analytic schedule exactly:
    per-rank bytes summed over phases == wire_bytes_model bytes, and the
    phase count == the model's serialized step count."""
    for ji, job in enumerate(prog.jobs):
        if job.endless or job.nodes is None:
            continue
        n = len(job.nodes)
        if n < 2:
            continue
        model = wire_bytes_model(WIRE_KIND[job.collective], n,
                                 job.vector_bytes)
        got = job_wire_stats(prog, ji)
        if not np.isclose(got["bytes"], model["bytes"], rtol=1e-6):
            raise ValueError(
                f"job {job.name!r} ({job.collective}, n={n}): per-rank "
                f"bytes {got['bytes']:.6g} != model {model['bytes']:.6g}")
        want_steps = model["steps"] if job.phased else 1
        if job.collective == "alltoall" and job.phased:
            # phased alltoall uses the pairwise schedule's step count
            want_steps = wire_bytes_model("pairwise_all_to_all", n,
                                          job.vector_bytes)["steps"]
        if got["steps"] != want_steps:
            raise ValueError(
                f"job {job.name!r}: {got['steps']} phases != "
                f"{want_steps} model steps")


# --------------------------------------------------------------------------
# Padding to bucket dims (the scale-batched engine)
# --------------------------------------------------------------------------

# Name of the synthetic job that owns padding flow rows. It is
# envelope-gated (so pad flows are never victims) and its flows carry 0
# bytes (so they are never ``alive`` in the simulator).
PAD_JOB_NAME = "_pad"


def pad_rows(x: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad axis 0 of ``x`` to length ``n`` with ``fill``, keeping dtype:
    the one padding idiom of program tables, geometry fields and per-flow
    parameters."""
    out = np.full((n,) + x.shape[1:], fill, x.dtype)
    out[: len(x)] = x
    return out


def pad_program(prog: TrafficProgram, *, n_flows: int, n_jobs: int,
                n_phases: int) -> TrafficProgram:
    """Pad a program's flat arrays and job tables to bucket dims.

    Padding flows are (0 -> 0, 0 bytes) rows owned by a synthetic
    :data:`PAD_JOB_NAME` job at index ``n_jobs - 1``; padding jobs run an
    empty single-phase program. :func:`check_program` stays exact on the
    valid prefix: it iterates ``prog.jobs`` only and masks flows by owning
    job."""
    F, J, P = prog.n_flows, len(prog.n_phases), int(prog.phase_gap.shape[1])
    if n_flows < F or n_jobs < J or n_phases < P:
        raise ValueError(f"pad_program: target ({n_flows}, {n_jobs}, "
                         f"{n_phases}) smaller than ({F}, {J}, {P})")
    if n_flows > F and n_jobs == J:
        raise ValueError("padding flows need a padding job to own them: "
                         "grow n_jobs alongside n_flows")
    pad_j = n_jobs - 1  # all pad flows attach to the last pad job
    phase_gap = np.zeros((n_jobs, n_phases), np.float32)
    phase_gap[:J, :P] = prog.phase_gap
    return TrafficProgram(
        jobs=prog.jobs,  # real jobs only: check_program sees the prefix
        src=pad_rows(prog.src, n_flows, 0),
        dst=pad_rows(prog.dst, n_flows, 0),
        bytes_per_phase=pad_rows(prog.bytes_per_phase, n_flows, 0.0),
        flow_job=pad_rows(prog.flow_job, n_flows, pad_j),
        flow_phase=pad_rows(prog.flow_phase, n_flows, 0),
        n_phases=pad_rows(prog.n_phases, n_jobs, 1),
        phase_gap=phase_gap,
        env_gated=pad_rows(prog.env_gated, n_jobs, True),
        sweep_mask=pad_rows(prog.sweep_mask, n_flows, False))


def split_nodes(nodes: Sequence[int],
                jobs: Sequence[JobSpec]) -> List[JobSpec]:
    """Interleave an allocation among jobs missing a node set (paper
    §III-A: round-robin striping maximizes network sharing). Jobs that
    already carry nodes keep them, and their nodes are excluded from the
    striping so tenants never share a NIC by accident."""
    pinned = {int(x) for j in jobs if j.nodes is not None for x in j.nodes}
    avail = np.asarray([int(x) for x in nodes if int(x) not in pinned])
    need = [i for i, j in enumerate(jobs) if j.nodes is None]
    out = list(jobs)
    for slot, ji in enumerate(need):
        out[ji] = jobs[ji].with_nodes(avail[slot::len(need)])
    return out
