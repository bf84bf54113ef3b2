"""Fluid flow-level fabric simulator in PyTorch, batched over cells.

Multi-job flow programs (traffic.py) traverse a :class:`Topology` under
a congestion-control model (cc.py) and a routing policy. Each step:

  1. injection demand from per-flow CC rate limits, gated by phase
     membership and the aggressor envelope; with a fault table, the link
     capacities scaled by the cell's fault events at sim time t; with the
     intra-node stage armed, each source's flows sharing its node's
     internal bandwidth ahead of the NIC,
  2. per-flow path choice by the cell's routing policy (fixed / ECMP /
     NSLB tables, adaptive min-queue, flowlet re-pathing),
  3. the fused step core (kernels: NIC limit, backpressure stall, staged
     FIFO propagation, queue update),
  4. ECN/credit signals and the CC rate update per fabric kind,
  5. per-job phase advance, barrier-gated on the slowest member flow,
     and program-completion bookkeeping.

Two structures carry a run: :class:`FabricGeometry` (static structure of
one experiment, shared by every cell of a sweep, or one row a cell in the
scale-batched engine) and :class:`SimParams` (everything a sweep varies,
with a leading cell axis on every field).
Where the JAX reference switches on per-cell data (routing policy, CC
kind) under ``vmap``, this port evaluates the branches that occur in the
batch and selects with ``torch.where``. Every float is float32, the sim
clock included.

A run is a host loop over ``chunk``-step Python loops with one device
sync per chunk; a cell whose primary job has finished is frozen (its
state and chunk count stop) while the others run on.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.envelopes import (ENV_RANDOM, GROUP_EDGE_DOWN,
                                        GROUP_EDGE_UP, GROUP_FABRIC,
                                        GROUP_HOT, GROUP_SWITCH, envelope_at,
                                        fault_rows, fault_scale_at)
from repro_torch.core.fabric.cc import (KIND_AI_ECN, KIND_DCQCN, KIND_IB,
                                        KIND_SLINGSHOT)
from repro_torch.core.fabric.routing import (POLICY_ADAPTIVE, POLICY_ECMP,
                                             POLICY_FIXED, POLICY_FLOWLET,
                                             POLICY_NSLB)
from repro_torch.core.fabric.topology import Topology
from repro_torch.core.traffic import pad_rows
from repro_torch.kernels import ops as kernel_ops

# Fixed iteration-time buffer; completed iterations beyond it fold into
# the last slot.
TDONE_SLOTS = 96

# Steps taken by _step_impl since import (or since a caller reset it).
step_count = 0

_F32 = torch.float32
_I32 = torch.int32
_I64 = torch.int64


def check_iter_budget(n_iters: int) -> None:
    if n_iters > TDONE_SLOTS:
        raise ValueError(
            f"n_iters={n_iters} exceeds the {TDONE_SLOTS}-slot iteration "
            "buffer (raise TDONE_SLOTS or lower n_iters)")


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; without one that is an error, never
    a silent CPU run. Pass ``device="cpu"`` to run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class FlowSet:
    """Static flow structure for one experiment (a packed traffic
    program: every flow belongs to one phase of one job). Host-side
    numpy."""

    paths: np.ndarray  # (F, K, H) link ids, pad = L (sink)
    n_paths: np.ndarray  # (F,)
    path_len: np.ndarray  # (F, K) hop counts
    is_victim: np.ndarray  # (F,) bool — flow of a non-envelope-gated job
    bytes_per_iter: np.ndarray  # (F,) bytes per phase visit
    fixed_choice: np.ndarray  # (F,) host-side static assignment
    host_caps: np.ndarray  # (F,) injection-link capacity per flow
    src_id: np.ndarray  # (F,) source node (NIC injection limiting)
    ecmp_choice: Optional[np.ndarray] = None  # (F,)
    nslb_choice: Optional[np.ndarray] = None  # (F,)
    flow_job: Optional[np.ndarray] = None  # (F,) owning job id
    flow_phase: Optional[np.ndarray] = None  # (F,) phase within the job
    n_phases: Optional[np.ndarray] = None  # (J,) program length per job
    phase_gap: Optional[np.ndarray] = None  # (J, P) compute gap per phase
    sweep_mask: Optional[np.ndarray] = None  # (F,) bytes scale with sweep
    job_names: Optional[List[str]] = None

    def __post_init__(self):
        if self.ecmp_choice is None:
            self.ecmp_choice = np.asarray(self.fixed_choice, np.int32)
        if self.nslb_choice is None:
            self.nslb_choice = np.asarray(self.fixed_choice, np.int32)
        if self.flow_job is None:
            self.flow_job = np.where(self.is_victim, 0, 1).astype(np.int32)
        if self.flow_phase is None:
            self.flow_phase = np.zeros(len(self.is_victim), np.int32)
        if self.n_phases is None:
            n_jobs = int(self.flow_job.max()) + 1 if len(self.flow_job) \
                else 1
            self.n_phases = np.ones((n_jobs,), np.int32)
        if self.phase_gap is None:
            self.phase_gap = np.zeros((len(self.n_phases), 1), np.float32)
        if self.sweep_mask is None:
            self.sweep_mask = np.asarray(self.is_victim, bool)
        if self.job_names is None:
            self.job_names = [f"job{j}" for j in range(len(self.n_phases))]

    @property
    def n_flows(self) -> int:
        return len(self.is_victim)

    @property
    def n_jobs(self) -> int:
        return len(self.n_phases)


def pack_paths(paths_per_flow: List[List[List[int]]], sink: int,
               k_max: int = 4):
    F = len(paths_per_flow)
    H = max((len(p) for ps in paths_per_flow for p in ps), default=1)
    out = np.full((F, k_max, H), sink, np.int32)
    n_paths = np.zeros((F,), np.int32)
    plen = np.zeros((F, k_max), np.int32)
    for f, ps in enumerate(paths_per_flow):
        ps = ps[:k_max] if ps else [[]]
        n_paths[f] = len(ps)
        for k, p in enumerate(ps):
            out[f, k, : len(p)] = p
            plen[f, k] = len(p)
    return out, n_paths, plen


# --------------------------------------------------------------------------
# Static geometry
# --------------------------------------------------------------------------

# field -> dtype. int32 rows are the kernel's operands (and link ids);
# int64 rows index tensors in the step.
GEOMETRY_FIELDS = {
    "caps_pad": _F32, "caps_finite": _F32, "dst_sw": _I32, "src_sw": _I32,
    "paths": _I32, "n_paths": _I64, "spray_choice": _I64, "path_len": _F32,
    "is_victim": torch.bool, "fixed_choice": _I64, "ecmp_choice": _I64,
    "nslb_choice": _I64, "src_id": _I32, "flow_job": _I64,
    "flow_phase": _I64, "n_phases": _I64, "phase_gap": _F32,
    "link_group": _I32, "link_sw_group": _I32,
}


@dataclasses.dataclass(frozen=True)
class FabricGeometry:
    """Link capacities, switch adjacency, packed flow paths and the
    traffic-program tables, as tensors on one device. Shared by every
    cell of a batched run, or, with a leading axis on every tensor field
    (:func:`stack_geometries`, :meth:`take`), one row a geometry or a cell
    (``per_cell``). ``from_numpy`` builds one from the JAX package's field
    arrays."""

    caps_pad: torch.Tensor  # (L+1,) with inf sink
    caps_finite: torch.Tensor  # (L+1,) with 1.0 sink
    dst_sw: torch.Tensor  # (L+1,) switch fed by each link (0 = host)
    src_sw: torch.Tensor  # (L+1,) switch feeding each link (0 = host)
    paths: torch.Tensor  # (F, K, H)
    n_paths: torch.Tensor  # (F,)
    spray_choice: torch.Tensor  # (F,) deterministic sprayed home path
    path_len: torch.Tensor  # (F, K) float
    is_victim: torch.Tensor  # (F,) bool
    fixed_choice: torch.Tensor  # (F,)
    ecmp_choice: torch.Tensor  # (F,)
    nslb_choice: torch.Tensor  # (F,)
    src_id: torch.Tensor  # (F,) dense source ids
    flow_job: torch.Tensor  # (F,)
    flow_phase: torch.Tensor  # (F,) phase membership, < 0 = every phase
    n_phases: torch.Tensor  # (J,)
    phase_gap: torch.Tensor  # (J, P)
    link_group: torch.Tensor  # (L+1,) structural fault groups
    link_sw_group: torch.Tensor  # (L+1,)
    L: int
    n_sw: int
    n_src: int
    n_jobs: int
    intra_node: int = 0

    def __post_init__(self):
        # constants the step derives from the geometry alone, computed once
        F, K, H = self.paths.shape[-3:]
        dev = self.paths.device
        victims = self.is_victim.reshape(-1, F).any(0).nonzero()
        derived = {
            # minimal-path bias of the routing score
            "path_bias": 0.05 * self.path_len
            / torch.clamp_min(self.path_len[..., :1], 1),
            "k_valid": torch.arange(K, device=dev)
            < self.n_paths[..., None],
            "job_ar": torch.arange(self.n_jobs, device=dev),
            "wildcard": self.flow_phase < 0,
            "tdone_ar": torch.arange(TDONE_SLOTS, device=dev),
            "n_victims": torch.clamp_min(self.is_victim.sum(-1), 1)
            .to(_F32).reshape(-1),
            # one past the last flow that is a victim in any row: the
            # victim sums run over [0, victim_end)
            "victim_end": int(victims.max()) + 1 if len(victims) else 0,
        }
        # the adaptive score's gather index into a cell's queue row: one
        # row, or one a cell
        derived["paths_idx"] = self.paths.reshape(-1, F * K * H).to(_I64)
        if self.intra_node:
            derived["src_flows"] = source_table(self.src_id, self.n_src)
        for k, v in derived.items():
            object.__setattr__(self, k, v)

    @property
    def per_cell(self) -> bool:
        """Whether every tensor field has a leading row axis."""
        return self.paths.dim() == 4

    @property
    def n_flows(self) -> int:
        return self.is_victim.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.paths.device

    def meta(self) -> dict:
        return {"L": self.L, "n_sw": self.n_sw, "n_src": self.n_src,
                "n_jobs": self.n_jobs, "intra_node": self.intra_node}

    def _map(self, fn) -> "FabricGeometry":
        return FabricGeometry(
            **{k: fn(getattr(self, k)) for k in GEOMETRY_FIELDS},
            **self.meta())

    def to(self, device) -> "FabricGeometry":
        device = torch.device(device)
        if device == self.device:
            return self
        return self._map(lambda x: x.to(device))

    def take(self, idx: torch.Tensor) -> "FabricGeometry":
        """The rows ``idx`` of a stacked geometry: one row a cell."""
        if not self.per_cell:
            raise ValueError("take needs a stacked geometry "
                             "(stack_geometries)")
        return self._map(lambda x: x[idx].contiguous())

    @classmethod
    def from_numpy(cls, arrays: dict, *, L: int, n_sw: int, n_src: int,
                   n_jobs: int, intra_node: int = 0,
                   device="cpu") -> "FabricGeometry":
        return cls(**{k: torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                         device=device)
                      for k, dt in GEOMETRY_FIELDS.items()},
                   L=int(L), n_sw=int(n_sw), n_src=int(n_src),
                   n_jobs=int(n_jobs), intra_node=int(intra_node))


def source_table(src_id: torch.Tensor, n_src: int) -> torch.Tensor:
    """Each source's flows, for sums in a fixed order: (R, n_src, W)
    int64 flow ids, R the rows of ``src_id`` ((F,) is one row), each
    source's flows in flow order and padded with F, an index past the
    last flow that reads a 0 (:func:`source_sums`). W is a power of two,
    so a source's pairwise sum keeps its bits whatever W a bucket's other
    rows force."""
    F = src_id.shape[-1]
    s = src_id.reshape(-1, F).to(_I64)
    R, dev = s.shape[0], s.device
    order = torch.argsort(s, dim=1, stable=True)
    grouped = s.gather(1, order)
    counts = torch.zeros((R, n_src), dtype=_I64, device=dev).scatter_add_(
        1, s, torch.ones_like(s))
    width = 1 << max(0, int(counts.max()) - 1).bit_length() if F else 1
    start = torch.cumsum(counts, 1) - counts
    pos = torch.arange(F, device=dev) - start.gather(1, grouped)
    table = torch.full((R, n_src, width), F, dtype=_I64, device=dev)
    table[torch.arange(R, device=dev)[:, None], grouped, pos] = order
    return table


def source_sums(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B, F) per-flow values summed per source, (B, n_src), or (B, C, F)
    values of C channels, (B, C, n_src): the flows of
    :func:`source_table` gathered and folded as a pairwise tree,
    ((x0 + x1) + (x2 + x3)) + ..., the same elementwise adds on the CPU
    and the card and no float atomics (``index_add_`` would use them)."""
    one = x.dim() == 2
    if one:
        x = x[:, None]
    B, C, F = x.shape
    R, n_src, width = table.shape
    padded = torch.nn.functional.pad(x, (0, 1))  # index F reads 0
    g = padded.gather(2, table.reshape(R, 1, n_src * width)
                      .expand(B, C, -1)).view(B, C, n_src, width)
    while g.shape[-1] > 1:
        g = g[..., 0::2] + g[..., 1::2]
    return g[:, 0, :, 0] if one else g[..., 0]


def make_geometry(topo: Topology, flows: FlowSet, prune: bool = True,
                  intra_node: bool = False, device="cpu") -> FabricGeometry:
    """Bind a flow set to a topology.

    ``prune=True`` (default) restricts the per-link arrays to the links
    some flow path references, remapping link ids densely (and likewise
    switch/source ids); untouched links can never interact with a flow,
    so flow-visible outputs are unchanged."""
    L_full = len(topo.caps)
    paths_np = np.asarray(flows.paths)
    if prune:
        used = np.unique(paths_np[paths_np < L_full]).astype(np.int64)
    else:
        used = np.arange(L_full, dtype=np.int64)
    L = len(used)
    remap = np.full((L_full + 1,), L, np.int32)
    remap[used] = np.arange(L, dtype=np.int32)
    paths_np = remap[paths_np]  # old sink (== L_full) -> new sink (== L)
    caps = np.asarray(topo.caps, np.float64)[used]
    # link <-> switch adjacency for backpressure spreading
    sw_ids: dict = {}
    dst_sw = np.zeros(L + 1, np.int32)
    src_sw = np.zeros(L + 1, np.int32)
    for li, gi in enumerate(used):
        a, b = topo.link_names[int(gi)]
        if not (isinstance(b, tuple) and b[0] == "h"):
            dst_sw[li] = 1 + sw_ids.setdefault(b, len(sw_ids))
        if not (isinstance(a, tuple) and a[0] == "h"):
            src_sw[li] = 1 + sw_ids.setdefault(a, len(sw_ids))
    n_sw = len(sw_ids) + 2  # 0 == "no switch" (host endpoints)
    # structural fault-targeting groups (edge-up / edge-down / fabric, the
    # most-traversed link promoted to GROUP_HOT, the busiest switch's links
    # to GROUP_SWITCH); the sink stays GROUP_NONE
    link_group = np.zeros(L + 1, np.int32)
    for li, gi in enumerate(used):
        a, b = topo.link_names[int(gi)]
        if isinstance(a, tuple) and a[0] == "h":
            link_group[li] = GROUP_EDGE_UP
        elif isinstance(b, tuple) and b[0] == "h":
            link_group[li] = GROUP_EDGE_DOWN
        else:
            link_group[li] = GROUP_FABRIC
    traversals = np.bincount(paths_np[paths_np < L].ravel(), minlength=L)
    if traversals.size and traversals.max() > 0:
        link_group[int(np.argmax(traversals))] = GROUP_HOT
    link_sw_group = np.zeros(L + 1, np.int32)
    if traversals.size and traversals.max() > 0:
        sw_load = np.zeros(n_sw, np.float64)
        np.add.at(sw_load, src_sw[:L], traversals)
        np.add.at(sw_load, dst_sw[:L], traversals)
        sw_load[0] = 0.0  # "no switch" (host endpoints) is not a switch
        if sw_load.max() > 0:
            hot_sw = int(np.argmax(sw_load))
            incident = (src_sw[:L] == hot_sw) | (dst_sw[:L] == hot_sw)
            link_sw_group[:L][incident] = GROUP_SWITCH
    # source (NIC) ids densified the same way
    src_raw = np.asarray(flows.src_id, np.int64)
    if prune and len(src_raw):
        _, src_dense = np.unique(src_raw, return_inverse=True)
        n_src = int(src_dense.max()) + 1
    else:
        src_dense = src_raw
        n_src = int(src_raw.max()) + 1 if len(src_raw) else 1
    # sprayed "home" path per flow: a deterministic hash spread
    F = flows.n_flows
    spray = (np.arange(F, dtype=np.int64) * 2654435761 % (1 << 31)) \
        % np.maximum(flows.n_paths, 1)
    arrays = {
        "caps_pad": np.concatenate([caps, [np.inf]]).astype(np.float32),
        "caps_finite": np.concatenate([caps, [1.0]]).astype(np.float32),
        "dst_sw": dst_sw, "src_sw": src_sw, "paths": paths_np,
        "n_paths": flows.n_paths, "spray_choice": spray,
        "path_len": np.asarray(flows.path_len, np.float32),
        "is_victim": flows.is_victim, "fixed_choice": flows.fixed_choice,
        "ecmp_choice": flows.ecmp_choice, "nslb_choice": flows.nslb_choice,
        "src_id": src_dense, "flow_job": flows.flow_job,
        "flow_phase": flows.flow_phase, "n_phases": flows.n_phases,
        "phase_gap": np.asarray(flows.phase_gap, np.float32),
        "link_group": link_group, "link_sw_group": link_sw_group,
    }
    return FabricGeometry.from_numpy(arrays, L=L, n_sw=n_sw, n_src=n_src,
                                     n_jobs=flows.n_jobs,
                                     intra_node=int(bool(intra_node)),
                                     device=device)


# --------------------------------------------------------------------------
# Geometry padding: heterogeneous topologies in one batch
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeometryDims:
    """Bucket shape every member geometry is padded to. Equal dims make
    geometries stackable (:func:`stack_geometries`); routing policy is
    per-cell data, so mixed-routing cells share a bucket."""

    n_links: int  # L (sink lives at index n_links)
    n_flows: int
    k_max: int
    max_hops: int
    n_sw: int
    n_src: int
    n_jobs: int
    n_phases: int
    # 0/1 flag, not a size: never rounded up by a bucket policy
    intra_node: int = 0


def geometry_dims(geom: FabricGeometry) -> GeometryDims:
    return GeometryDims(
        n_links=geom.L, n_flows=geom.n_flows,
        k_max=int(geom.paths.shape[-2]), max_hops=int(geom.paths.shape[-1]),
        n_sw=geom.n_sw, n_src=geom.n_src, n_jobs=geom.n_jobs,
        n_phases=int(geom.phase_gap.shape[-1]),
        intra_node=int(geom.intra_node))


_DIM_FLAG_FIELDS = ("intra_node",)


def bucket_dims(geoms: Sequence[FabricGeometry],
                round_up=None) -> GeometryDims:
    """Elementwise max over member dims, each optionally rounded up by
    ``round_up`` (a bucket-size policy); flag fields max without
    rounding."""
    dims = [geometry_dims(g) for g in geoms]
    out = {}
    for f in dataclasses.fields(GeometryDims):
        v = max(getattr(d, f.name) for d in dims)
        if round_up is not None and f.name not in _DIM_FLAG_FIELDS:
            v = round_up(v)
        out[f.name] = v
    return GeometryDims(**out)


def pad_geometry(geom: FabricGeometry, dims: GeometryDims) -> FabricGeometry:
    """Pad one geometry to a bucket shape with inert padding, so a padded
    cell runs bit for bit as it runs alone (tests/test_torch_scale.py):

    * pad links ([L, n_links)) are referenced by no path, see zero
      arrival and belong to switch 0 (whose stall is pinned to 1);
    * pad flows carry a sink-only path, zero path length, source
      ``n_src - 1`` and ``is_victim == False``; their bytes (SimParams)
      are 0, which keeps them out of ``alive``, so they inject 0.0;
    * pad jobs have ``n_phases == 1`` and no member flows;
    * pad switches and sources are referenced by no link or real flow.

    The old sink (index ``geom.L``) is remapped to the new sink
    (``dims.n_links``) everywhere in the path table. On the CPU; the
    result lies where ``geom`` does."""
    cur = geometry_dims(geom)
    for f in dataclasses.fields(GeometryDims):
        if getattr(dims, f.name) < getattr(cur, f.name):
            raise ValueError(
                f"pad_geometry: {f.name}={getattr(dims, f.name)} < "
                f"current {getattr(cur, f.name)}")
    a = {k: getattr(geom, k).cpu().numpy() for k in GEOMETRY_FIELDS}
    L_old, L_new = geom.L, dims.n_links
    F, J = dims.n_flows, dims.n_jobs
    paths = np.where(a["paths"] >= L_old, L_new, a["paths"]).astype(np.int32)
    padded = np.full((F, dims.k_max, dims.max_hops), L_new, np.int32)
    padded[: paths.shape[0], : paths.shape[1], : paths.shape[2]] = paths
    path_len = np.zeros((F, dims.k_max), np.float32)
    path_len[: a["path_len"].shape[0], : a["path_len"].shape[1]] = \
        a["path_len"]

    def links(name, fill, dtype):
        out = np.full((L_new + 1,), fill, dtype)
        out[:L_old] = a[name][:L_old]
        return out
    phase_gap = np.zeros((J, dims.n_phases), np.float32)
    phase_gap[: a["phase_gap"].shape[0], : a["phase_gap"].shape[1]] = \
        a["phase_gap"]
    arrays = {
        "caps_pad": links("caps_pad", np.inf, np.float32),
        "caps_finite": links("caps_finite", 1.0, np.float32),
        "dst_sw": links("dst_sw", 0, np.int32),
        "src_sw": links("src_sw", 0, np.int32),
        # pad links stay GROUP_NONE: no fault event can ever scale them
        "link_group": links("link_group", 0, np.int32),
        "link_sw_group": links("link_sw_group", 0, np.int32),
        "paths": padded, "path_len": path_len,
        "n_paths": pad_rows(a["n_paths"], F, 1),
        "spray_choice": pad_rows(a["spray_choice"], F, 0),
        "is_victim": pad_rows(a["is_victim"], F, False),
        "fixed_choice": pad_rows(a["fixed_choice"], F, 0),
        "ecmp_choice": pad_rows(a["ecmp_choice"], F, 0),
        "nslb_choice": pad_rows(a["nslb_choice"], F, 0),
        "src_id": pad_rows(a["src_id"], F, dims.n_src - 1),
        "flow_job": pad_rows(a["flow_job"], F, J - 1),
        "flow_phase": pad_rows(a["flow_phase"], F, 0),
        "n_phases": pad_rows(a["n_phases"], J, 1), "phase_gap": phase_gap,
    }
    return FabricGeometry.from_numpy(
        arrays, L=L_new, n_sw=dims.n_sw, n_src=dims.n_src, n_jobs=J,
        intra_node=dims.intra_node, device=geom.device)


def stack_geometries(geoms: Sequence[FabricGeometry]) -> FabricGeometry:
    """Stack same-shape geometries into one with a leading row axis on
    every tensor field. All meta fields must agree: pad to a common
    :class:`GeometryDims` first."""
    metas = {tuple(g.meta().values()) for g in geoms}
    if len(metas) != 1:
        raise ValueError(f"cannot stack geometries with differing meta "
                         f"fields: {sorted(metas)}")
    return FabricGeometry(
        **{k: torch.stack([getattr(g, k) for g in geoms])
           for k in GEOMETRY_FIELDS}, **geoms[0].meta())


# --------------------------------------------------------------------------
# Per-cell sweep parameters
# --------------------------------------------------------------------------

# field -> dtype; every field carries a leading cell axis once stacked
PARAM_FIELDS = {
    "dt": _F32, "bytes_per_iter": _F32, "host_caps": _F32, "env": _F32,
    "policy": _I64, "flowlet_gap_s": _F32, "flow_start": _F32,
    "fct_mask": _F32, "fault": _F32, "node_cap": _F32, "kind": _I64,
    "qmax_bytes": _F32, "kmin": _F32, "kmax": _F32, "md": _F32,
    "rai_frac": _F32, "cc_interval_s": _F32, "hol_factor": _F32,
    "hol_start": _F32, "min_rate_frac": _F32, "follow_tau_s": _F32,
    "follow_gain": _F32, "thresh_adapt": _F32, "burst_jitter": _F32,
    "iter_drain": _F32,
}


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Per-cell parameters, one tensor per field. :func:`make_params`
    builds one cell (no batch axis); :func:`stack_params` stacks cells
    along a leading axis, which the step and the runners require."""

    dt: torch.Tensor  # seconds
    bytes_per_iter: torch.Tensor  # (F,)
    host_caps: torch.Tensor  # (F,)
    env: torch.Tensor  # (ENV_COMPONENTS, 5) congestion-envelope rows
    policy: torch.Tensor  # routing.POLICY_*
    flowlet_gap_s: torch.Tensor
    flow_start: torch.Tensor  # () or (F,) seconds
    fct_mask: torch.Tensor  # () or (F,)
    # link-fault table (FAULT_EVENTS, FAULT_FIELDS) or None; None keeps the
    # step free of the fault stage, the all-``none`` table scales by 1.0
    fault: Optional[torch.Tensor]
    # intra-node stage capacity, () or (n_src,) bytes/s; inf = inert
    node_cap: torch.Tensor
    kind: torch.Tensor  # () or (F,) cc.KIND_*
    qmax_bytes: torch.Tensor
    kmin: torch.Tensor
    kmax: torch.Tensor
    md: torch.Tensor
    rai_frac: torch.Tensor
    cc_interval_s: torch.Tensor
    hol_factor: torch.Tensor
    hol_start: torch.Tensor
    min_rate_frac: torch.Tensor
    follow_tau_s: torch.Tensor
    follow_gain: torch.Tensor
    thresh_adapt: torch.Tensor
    burst_jitter: torch.Tensor
    iter_drain: torch.Tensor

    def _map(self, fn) -> "SimParams":
        return SimParams(**{k: None if getattr(self, k) is None
                            else fn(getattr(self, k)) for k in PARAM_FIELDS})

    def to(self, device) -> "SimParams":
        return self._map(lambda x: x.to(device))

    def take(self, idx: torch.Tensor) -> "SimParams":
        """The cells ``idx`` of a stacked SimParams."""
        return self._map(lambda x: x[idx])

    @classmethod
    def from_numpy(cls, arrays: dict, device="cpu") -> "SimParams":
        return cls(**{k: None if arrays.get(k) is None
                      else torch.as_tensor(np.array(arrays[k]), dtype=dt,
                                           device=device)
                      for k, dt in PARAM_FIELDS.items()})


def make_params(cc, *, dt: float, bytes_per_iter: np.ndarray,
                host_caps: np.ndarray, env: np.ndarray,
                policy: int = POLICY_FIXED,
                flowlet_gap_s: float = 200e-6,
                flow_start=0.0, fct_mask=0.0,
                fault=None, node_cap=np.inf) -> SimParams:
    """One cell's parameters (no batch axis) on the CPU."""
    return SimParams.from_numpy({
        "dt": dt, "bytes_per_iter": bytes_per_iter, "host_caps": host_caps,
        "env": env, "policy": policy, "flowlet_gap_s": flowlet_gap_s,
        "flow_start": flow_start, "fct_mask": fct_mask, "fault": fault,
        "node_cap": node_cap, "kind": cc.kind, "qmax_bytes": cc.qmax_bytes,
        "kmin": cc.kmin, "kmax": cc.kmax, "md": cc.md,
        "rai_frac": cc.rai_frac, "cc_interval_s": cc.cc_interval_s,
        "hol_factor": cc.hol_factor, "hol_start": cc.hol_start,
        "min_rate_frac": cc.min_rate_frac, "follow_tau_s": cc.follow_tau_s,
        "follow_gain": cc.follow_gain,
        "thresh_adapt": 1.0 if cc.thresh_adapt else 0.0,
        "burst_jitter": cc.burst_jitter, "iter_drain": cc.iter_drain})


def stack_params(params: List[SimParams]) -> SimParams:
    """Stack per-cell SimParams along a new leading cell axis."""
    return SimParams(**{
        k: None if getattr(params[0], k) is None
        else torch.stack([getattr(p, k) for p in params])
        for k in PARAM_FIELDS})


# --------------------------------------------------------------------------
# State and step
# --------------------------------------------------------------------------


def _per_flow(x: torch.Tensor) -> torch.Tensor:
    """A (B,) per-cell or (B, F) per-flow parameter, broadcastable to
    (B, F)."""
    return x if x.dim() == 2 else x[:, None]


def init_state(geom: FabricGeometry, p: SimParams,
               metrics: bool = False) -> dict:
    """Initial state of a stacked batch of cells (leading cell axis).
    ``metrics=True`` adds the streaming-statistics leaves (core/metrics.py),
    O(bins + F + J) a cell whatever the step count, which the step updates
    when they are present: ``armed_t``, ``hist`` (the queue-delay and FCT
    histograms, (B, 2, NBINS), returned by a run as ``h_qd`` and
    ``h_fct``), ``wn``, ``wmean`` and ``wm2``."""
    state = _base_state(geom, p)
    if metrics:
        from repro_torch.core.metrics import NBINS
        B, F, J = p.dt.shape[0], geom.n_flows, geom.n_jobs
        dev = p.dt.device
        zeros = lambda *shape: torch.zeros(shape, dtype=_F32,  # noqa: E731
                                           device=dev)
        state.update({
            # when each flow armed its current byte budget: a short flow at
            # its arrival, a tenant flow at every phase entry; a completion
            # at t samples FCT = t - armed_t
            "armed_t": zeros(B, F) + _per_flow(p.flow_start),
            "hist": zeros(B, 2, NBINS),
            "wn": zeros(B, J), "wmean": zeros(B, J), "wm2": zeros(B, J),
        })
    return state


def _base_state(geom: FabricGeometry, p: SimParams) -> dict:
    B = p.dt.shape[0]
    F, J, L1 = geom.n_flows, geom.n_jobs, geom.L + 1
    dev = p.dt.device

    def zeros(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "c": p.host_caps.clone(),
        "rem": p.bytes_per_iter.clone(),
        "q": zeros(B, L1),
        "arr": zeros(B, L1),
        "thresh": torch.ones((B, L1), dtype=_F32, device=dev)
        * p.kmin[:, None] * p.qmax_bytes[:, None],
        "last_dec": zeros(B, F),
        # routing state: flowlet current path + idle time, per-flow
        # delivered-bytes accumulator
        "rc": geom.spray_choice.expand(B, F).clone(),
        "idle": zeros(B, F),
        "fbytes": zeros(B, F),
        # traffic-program state: per-job phase counter, remaining compute
        # gap of the current phase, completed program iterations
        "ph": zeros(B, J, dtype=_I64),
        "gap": geom.phase_gap[..., 0].expand(B, J).clone(),
        "it": zeros(B, J, dtype=_I64),
        "t_done": zeros(B, J, TDONE_SLOTS),
        "qd_acc": zeros(B),
        "t": zeros(B),
    }


def run_constants(p: SimParams, geom: Optional[FabricGeometry] = None,
                  metrics: bool = False) -> dict:
    """What the step derives from the parameters alone, computed once per
    run instead of once per step:

    * the CC update's additive increase and credit-follower gain, on the
      CPU (where a division by a scalar rounds exactly), then moved;
    * the products of scalar knobs the signals and clip read, and the
      step core's packed scalar block;
    * which routing policies, CC kinds and envelope kinds occur in the
      batch. The step evaluates only those branches; a branch no cell
      selects cannot change any result;
    * with ``geom`` and ``metrics``, each job's flows
      (:func:`source_table` over ``flow_job``), the order the streaming
      metrics sum a job's samples in, and each flow's uncontended drain
      time, the denominator of its slowdown.
    """
    dev = p.dt.device
    dt, tau = p.dt.cpu(), p.follow_tau_s.cpu()
    inc = p.rai_frac.cpu()[:, None] * p.host_caps.cpu() * (dt / 1e-3)[:, None]
    f = 1.0 - torch.exp(-dt / torch.clamp_min(tau, 1e-9))
    policies = sorted(set(p.policy.cpu().tolist()))
    kinds = sorted(set(p.kind.cpu().reshape(-1).tolist()))
    if not set(policies) <= set(range(5)) or not set(kinds) <= set(range(4)):
        raise ValueError(f"unknown routing policy in {policies} or CC kind "
                         f"in {kinds}")
    col = lambda x: x[:, None]  # noqa: E731
    return {
        "inc": inc.to(dev), "f": col(f).to(dev),
        "kq": col(p.kmin * p.qmax_bytes), "kmax_q": col(p.kmax * p.qmax_bytes),
        "q05": col(0.05 * p.qmax_bytes),
        "min_c": col(p.min_rate_frac) * p.host_caps,
        "scalars": kernel_ops.pack_scalars(p.dt, p.qmax_bytes, p.hol_factor,
                                           p.hol_start, p.burst_jitter),
        "policies": policies, "kinds": kinds,
        "has_random": bool((p.env[..., 0].cpu() == ENV_RANDOM).any()),
        # fault-table slots that are not ``none`` in some cell
        "fault_rows": None if p.fault is None else fault_rows(p.fault),
        "job_flows": source_table(geom.flow_job, geom.n_jobs)
        if metrics else None,
        # ideal (line-rate) drain time, floored as the slowdown divides
        "ideal": torch.clamp_min(
            p.bytes_per_iter / torch.clamp_min(p.host_caps, 1.0), 1e-9)
        if metrics else None,
    }


def _select(key: torch.Tensor, branches: dict):
    """``branches[key]`` elementwise: the value of the branch whose id
    equals ``key``. Branches are given as callables and evaluated only
    here; the last one is the default."""
    ids = list(branches)
    out = branches[ids[-1]]()
    for i in reversed(ids[:-1]):
        out = torch.where(key == i, branches[i](), out)
    return out


def _cc_update(p: SimParams, c, a, fmark, fstrength, can_dec, consts):
    """Per-fabric rate update: each kind present in the batch is evaluated
    and the cell's (or flow's) kind selects one, as the reference does
    under ``vmap``."""
    inc, f = consts["inc"], consts["f"]
    md = p.md[:, None]
    dec = fmark & can_dec
    bottlenecked = fmark & (a < 0.95 * c)

    def ib():
        # credit semantics: the send window tracks what actually drains
        c2 = (1 - f) * c + f * torch.maximum(a * p.follow_gain[:, None],
                                             consts["min_c"])
        return torch.where(dec, c2 * md, c2 + inc)

    rules = {
        KIND_DCQCN: lambda: torch.where(dec, c * md, c + inc),
        KIND_IB: ib,
        # slingshot: throttle only flows actually bottlenecked
        KIND_SLINGSHOT: lambda: torch.where(
            bottlenecked, (1 - f) * c + f * a * p.follow_gain[:, None],
            c + inc),
        KIND_AI_ECN: lambda: torch.where(
            dec, c * (1.0 - (1.0 - md) * fstrength), c + inc),
    }
    kind = _per_flow(p.kind)
    c_new = _select(kind, {k: rules[k] for k in consts["kinds"]})
    if KIND_SLINGSHOT in consts["kinds"]:
        dec = torch.where(kind == KIND_SLINGSHOT, bottlenecked & can_dec,
                          dec)
    return c_new, dec


def victim_sums(rows: List[torch.Tensor], n: int) -> List[torch.Tensor]:
    """Each (B, F) row summed over its first ``n`` flows as a pairwise
    tree over a power of two: ((x0 + x1) + (x2 + x3)) + ..., zeros past
    ``n``. Elementwise adds round alike on the CPU and the card, and
    flows appended past ``n`` (a bucket's padding) or zeros there leave
    every sum's bits as they are, which ``Tensor.sum`` (its order set by
    the row's length) does not."""
    x = torch.stack(rows)[..., :n]
    width = 1 << max(0, n - 1).bit_length()
    if width != x.shape[-1]:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return list(x[..., 0])


def step(geom: FabricGeometry, p: SimParams, state: dict,
         core: Optional[str] = None):
    """One step of every cell; returns (new_state, victim goodput (B,))."""
    return _step_impl(geom, p, state, with_aux=False, core=core)


def step_debug(geom: FabricGeometry, p: SimParams, state: dict,
               core: Optional[str] = None):
    """Like :func:`step` but also returns an aux dict of internal rates
    (injection, served-stage maxima, effective capacities, ...). The state
    update is the identical computation."""
    return _step_impl(geom, p, state, with_aux=True, core=core)


def _step_impl(geom: FabricGeometry, p: SimParams, state: dict,
               with_aux: bool, core: Optional[str] = None,
               consts: Optional[dict] = None):
    global step_count
    step_count += 1
    metrics = "hist" in state
    if consts is None or (metrics and consts["job_flows"] is None):
        consts = run_constants(p, geom, metrics)
    B = p.dt.shape[0]
    F, K, H = geom.paths.shape[-3:]
    dt = p.dt
    dtc = dt[:, None]
    t = state["t"]
    # aggressor envelope at sim time t, per cell
    env_t = envelope_at(p.env, t, with_random=consts["has_random"])[:, None]
    # phase membership; negative phase id = member of every phase
    fjob = geom.flow_job.expand(B, F)
    in_phase = (geom.flow_phase == state["ph"].gather(1, fjob)) \
        | geom.wildcard
    alive = (state["rem"] > 0) & in_phase & (t[:, None]
                                             >= _per_flow(p.flow_start))
    active = (geom.is_victim | (env_t > 0)) & alive
    gate = torch.where(geom.is_victim, 1.0, env_t) * alive
    inject = state["c"] * gate

    # ---- link-fault engine ----
    # the per-link capacity scale at sim time t, applied outside the
    # kernel launch: kernel 1 reads the scaled capacities as its per-cell
    # caps operand. Without a table the step has none of these operations;
    # the all-``none`` table scales by exactly 1.0.
    caps_lk = geom.caps_finite
    if p.fault is not None:
        caps_lk = caps_lk * fault_scale_at(
            p.fault, geom.link_group.view(-1, geom.L + 1), t,
            geom.link_sw_group.view(-1, geom.L + 1),
            rows=consts["fault_rows"])

    # ---- intra-node stage (NVLink/PCIe ahead of the NIC) ----
    # a source's flows share its node's internal bandwidth in proportion
    # to their demand, one stage before the NIC limit; node_cap == inf
    # scales by exactly 1.0. Each source's load is summed in a fixed
    # order (source_sums), so a cell's bits do not depend on the batch.
    if geom.intra_node:
        nload = source_sums(inject, geom.src_flows)
        ncap = p.node_cap if p.node_cap.dim() == 2 else p.node_cap[:, None]
        nscale = torch.minimum(torch.ones_like(nload),
                               ncap / torch.clamp_min(nload, 1.0))
        inject = inject * nscale.gather(
            1, geom.src_id.to(_I64).expand(B, F))

    # ---- routing: the cell's policy selects one candidate table ----
    # Static tables are read as they are; the dynamic policies score
    # candidates by queue occupancy (``occ`` is shared with the core).
    occ = state["q"] / p.qmax_bytes[:, None]
    rc = state["rc"]
    policies = consts["policies"]
    if POLICY_ADAPTIVE in policies or POLICY_FLOWLET in policies:
        hops = occ.gather(1, geom.paths_idx.expand(B, -1)).view(B, F, K, H)
        score = hops.amax(dim=3) + geom.path_bias
        score = torch.where(geom.k_valid, score, float("inf"))
        best_score, best = score.min(dim=2)

        def hysteresis(anchor):
            # leave the anchor path only when clearly worse than the best
            a_score = score.gather(2, anchor.expand(B, F)[..., None])[..., 0]
            return torch.where(a_score > best_score + 0.10, best, anchor)

        flowlet = torch.where(state["idle"] >= p.flowlet_gap_s[:, None],
                              hysteresis(rc), rc) \
            if POLICY_FLOWLET in policies else None
    routes = {POLICY_FIXED: lambda: geom.fixed_choice,
              POLICY_ECMP: lambda: geom.ecmp_choice,
              POLICY_NSLB: lambda: geom.nslb_choice,
              POLICY_ADAPTIVE: lambda: hysteresis(geom.spray_choice),
              POLICY_FLOWLET: lambda: flowlet}
    pol = p.policy[:, None]
    choice = _select(pol, {k: routes[k] for k in policies}).expand(B, F)
    rc_new = rc if POLICY_FLOWLET not in policies else \
        torch.where(pol == POLICY_FLOWLET, flowlet, rc)
    idle_new = torch.where(active, 0.0, state["idle"] + dtc)
    plinks = geom.paths.expand(B, F, K, H).gather(
        2, choice[:, :, None, None].expand(B, F, 1, H))[:, :, 0]  # int32
    valid = plinks < geom.L
    pl_flat = plinks.reshape(B, F * H).to(_I64)

    # ---- fused step core (kernels/) ----
    out = kernel_ops.fabric_step_core(
        plinks, inject, geom.src_id, p.host_caps, state["q"], occ,
        caps_lk, geom.src_sw, geom.dst_sw, dt, p.qmax_bytes,
        p.hol_factor, p.hol_start, p.burst_jitter, n_src=geom.n_src,
        n_sw=geom.n_sw, with_aux=with_aux, core=core or "kernel",
        scalars=consts["scalars"])
    a = out["achieved"]
    q = out["q_new"]

    # ---- signals ----
    # AI-ECN: the threshold tracks a fraction of the observed queue;
    # thresh_adapt == 0 keeps the static kmin threshold
    adapted = torch.minimum(
        torch.maximum(0.9 * state["thresh"] + 0.1 * (0.5 * q + consts["kq"]),
                      consts["q05"]),
        consts["kmax_q"])
    thresh = torch.where(p.thresh_adapt[:, None] > 0, adapted,
                         state["thresh"])
    over_thresh = (q > thresh).gather(1, pl_flat).view(B, F, H)
    fmark = (over_thresh & valid).any(dim=2)
    # proportional mark strength (ai_ecn) in [0, 1]
    strength_l = torch.clamp((q - thresh) / (consts["kmax_q"] - thresh + 1.0),
                             0.0, 1.0)
    fstrength = torch.where(valid, strength_l.gather(1, pl_flat)
                            .view(B, F, H), 0.0).amax(dim=2)

    # ---- CC update ----
    c0 = state["c"]
    can_dec = state["last_dec"] >= p.cc_interval_s[:, None]
    c, dec = _cc_update(p, c0, a, fmark, fstrength, can_dec, consts)
    # CC state only evolves for flows that are actually transmitting
    c = torch.where(active, c, c0)
    dec = dec & active
    c = torch.minimum(torch.maximum(c, consts["min_c"]), p.host_caps)
    last_dec = torch.where(dec, 0.0, state["last_dec"] + dtc)

    # ---- progress + phase/program bookkeeping ----
    rem = state["rem"] - a * dtc
    done_now = alive & (rem <= 0)
    t_new = t + dt
    # per-job barrier: a phase completes when its slowest flow has drained
    pending = (in_phase & (rem > 0)).to(_I32)
    busy = torch.zeros((B, geom.n_jobs), dtype=_I32, device=dt.device) \
        .scatter_reduce_(1, fjob, pending, "amax", include_self=True) > 0
    gap = state["gap"] - dtc * (~busy)
    advance = ~busy & (gap <= 0)
    ph = state["ph"]
    ph_next = torch.where(advance, (ph + 1) % geom.n_phases, ph)
    wrap = advance & (ph + 1 >= geom.n_phases)
    J, P = geom.phase_gap.shape[-2:]
    gap = torch.where(advance, geom.phase_gap.expand(B, J, P).gather(
        2, ph_next[..., None])[..., 0], gap)
    # flows of the newly entered phase reload their byte budget
    enter = advance.gather(1, fjob) \
        & ((geom.flow_phase == ph_next.gather(1, fjob)) | geom.wildcard)
    rem = torch.where(enter, p.bytes_per_iter, rem)
    # a job wrapping its last phase completed one program iteration
    it = state["it"]
    slot = torch.clamp_max(it, TDONE_SLOTS - 1)
    onehot = geom.tdone_ar == slot[..., None]
    t_done = torch.where(wrap[..., None] & onehot, t_new[:, None, None],
                         state["t_done"])
    it = it + wrap.to(it.dtype)
    # the gap between iterations of the primary job partially drains queues
    q = torch.where(wrap[:, :1], q * p.iter_drain[:, None], q)

    # queueing delay experienced by victim flows (seconds), against the
    # fault-scaled capacity: a degraded link serves its queue slower
    qdel = torch.where(valid, (q / caps_lk).gather(1, pl_flat)
                       .view(B, F, H), 0.0).amax(dim=2)
    mean_qdel, vict_goodput = victim_sums(
        [qdel * geom.is_victim, a * geom.is_victim], geom.victim_end)
    mean_qdel = mean_qdel / geom.n_victims

    new_state = {"c": c, "rem": rem, "q": q, "arr": out["arrival"],
                 "thresh": thresh, "last_dec": last_dec,
                 "rc": rc_new, "idle": idle_new,
                 "fbytes": state["fbytes"] + a * dtc,
                 "ph": ph_next, "gap": gap, "it": it, "t_done": t_done,
                 "qd_acc": state["qd_acc"] + mean_qdel * dt, "t": t_new}
    if metrics:
        new_state.update(_metrics_update(
            geom, p, state, qdel, active, done_now, enter, t_new, consts))
    if with_aux:
        aux = {"inject": out["inject"], "achieved": a,
               "arrival": out["arrival"],
               "served_stage_max": out["served_stage_max"],
               "caps_eff": out["caps_eff"], "active": active,
               "advance": advance, "wrap": wrap, "qdel": qdel,
               "done": done_now}
        return new_state, vict_goodput, aux
    return new_state, vict_goodput


def _metrics_update(geom: FabricGeometry, p: SimParams, state: dict, qdel,
                    active, done_now, enter, t_new, consts) -> dict:
    """One step of the streaming metrics: every transmitting flow adds a
    queue-delay sample; every flow whose budget crossed zero this step
    (``done_now``, taken before the re-arm) adds an FCT sample where
    ``fct_mask`` is set, and its slowdown (FCT over the uncontended
    line-rate drain time) to its job's Welford accumulators."""
    from repro_torch.core import metrics as met

    fct = t_new[:, None] - state["armed_t"]
    hist = met.hist_add(
        state["hist"], torch.stack([qdel, fct], 1),
        torch.stack([active, done_now & (_per_flow(p.fct_mask) != 0)], 1))
    wn, wmean, wm2 = met.welford_update(
        state["wn"], state["wmean"], state["wm2"], fct / consts["ideal"],
        done_now, geom.flow_job.view(-1, geom.n_flows), consts["job_flows"])
    return {"armed_t": torch.where(enter, t_new[:, None], state["armed_t"]),
            "hist": hist, "wn": wn, "wmean": wmean, "wm2": wm2}


# --------------------------------------------------------------------------
# Runners
# --------------------------------------------------------------------------


def _run_cell(geom: FabricGeometry, p: SimParams, n_iters: int,
              chunk: int, max_chunks: int, stride: int,
              core: Optional[str] = None, with_trace: bool = True,
              metrics: bool = False) -> dict:
    """Run a stacked batch of cells to ``n_iters`` iterations of each
    cell's primary job (or the step budget), in chunks of ``chunk`` steps.

    Before every chunk one device sync reads which cells still run
    (``it[:, 0] < n_iters``); finished cells are frozen, so their state
    (the streaming-metrics leaves too) and chunk count stop where they
    were, and only the running cells (and, for a geometry with one row a
    cell, their rows) are stepped.

    ``metrics=True`` carries the streaming metrics and returns them
    (``h_qd``, ``h_fct``, ``wn``, ``wmean``, ``wm2``); ``with_trace=False``
    drops the strided goodput buffer, so a replay's memory does not grow
    with its step budget."""
    assert chunk % stride == 0, (chunk, stride)
    trace_chunk = chunk // stride
    B = p.dt.shape[0]
    dev = p.dt.device
    state = init_state(geom, p, metrics=metrics)
    buf = torch.zeros((B, max_chunks * trace_chunk if with_trace else 1),
                      dtype=_F32, device=dev)
    chunks = np.zeros((B,), np.int64)
    running = np.ones((B,), bool)
    for k in range(max_chunks):
        running &= (state["it"][:, 0] < n_iters).cpu().numpy()
        if not running.any():
            break
        idx = torch.as_tensor(np.flatnonzero(running), device=dev)
        whole = bool(running.all())
        sub = state if whole else {n: v[idx] for n, v in state.items()}
        sp = p if whole else p.take(idx)
        sg = geom if whole or not geom.per_cell else geom.take(idx)
        consts = run_constants(sp, sg, metrics)
        gps = []
        for s in range(chunk):
            sub, gp = _step_impl(sg, sp, sub, with_aux=False, core=core,
                                 consts=consts)
            if s % stride == 0:
                gps.append(gp)
        if with_trace:
            buf[idx, k * trace_chunk:(k + 1) * trace_chunk] = \
                torch.stack(gps, 1)
        if whole:
            state = sub
        else:
            for n, v in sub.items():
                state[n][idx] = v
        chunks[running] += 1
    out = {"t_done": state["t_done"], "it": state["it"],
           "qd_acc": state["qd_acc"], "t": state["t"],
           "fbytes": state["fbytes"], "trace": buf}
    if metrics:
        out.update({"h_qd": state["hist"][:, 0], "h_fct": state["hist"][:, 1],
                    **{k: state[k] for k in ("wn", "wmean", "wm2")}})
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["chunks"] = chunks
    return out


def run_cells(geom: FabricGeometry, params: SimParams, n_iters: int,
              *, chunk: int = 2048, max_chunks: int = 98, stride: int = 8,
              device=None, core: Optional[str] = None,
              with_trace: bool = True, metrics: bool = False) -> dict:
    """Batched engine: ``params`` has a leading cell axis on every field;
    all cells share ``geom``. Runs on ``device`` (default: the CUDA
    device) and returns numpy arrays with a leading cell axis."""
    device = resolve_device(device)
    return _run_cell(geom.to(device), params.to(device), int(n_iters),
                     chunk, max_chunks, stride, core, with_trace, metrics)


def run_cells_hetero(geoms: FabricGeometry, params: SimParams,
                     n_iters: int, *, chunk: int = 2048,
                     max_chunks: int = 98, stride: int = 8, device=None,
                     core: Optional[str] = None,
                     with_trace: bool = True, metrics: bool = False,
                     mesh=None, shard_axis: str = "cell",
                     donate: bool = False) -> dict:
    """Scale-batched engine: ``geoms`` is a stack of bucket-padded
    geometries (leading axis G, :func:`stack_geometries`) and ``params``
    carries two leading axes, (G, S): S sub-cells on each geometry. All
    G x S cells run as one batch, one launch of each kernel a step, each
    cell on its own geometry row. Returns numpy arrays with both leading
    axes.

    ``mesh`` (a sequence of devices, launch.mesh.make_sweep_mesh) splits
    the batch across its devices instead of running it on ``device``:
    ``shard_axis='cell'`` splits the geometries with their sub-cells,
    ``'lane'`` splits the sub-cells and gives every device all the
    geometries (the mitigation search's candidate axis). The batch is
    padded to a multiple of the device count by repeating index 0
    (:func:`pad_batch`), each contiguous shard runs on its device, one
    after another, and the padding is sliced off. A cell runs bit for bit
    as it does in any other batch, so the result equals the unsharded
    run's. PyTorch has no partitioned compile: this is also what the
    sweep launcher's ``dispatch='shard_map'`` runs. ``donate`` is
    accepted for the reference's signature; every shard is a slice the
    engine only reads, so nothing is donated."""
    if mesh is not None:
        return _run_sharded(geoms, params, n_iters, mesh, shard_axis,
                            chunk=chunk, max_chunks=max_chunks,
                            stride=stride, core=core,
                            with_trace=with_trace, metrics=metrics)
    G, S = params.dt.shape[:2]
    geom, flat = hetero_cells(geoms, params, device)
    out = _run_cell(geom, flat, int(n_iters), chunk, max_chunks, stride,
                    core, with_trace, metrics)
    return {k: v.reshape(G, S, *v.shape[1:]) for k, v in out.items()}


def mesh_devices(mesh) -> List[torch.device]:
    """The devices of a mesh (a sequence of devices or their names)."""
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def _run_sharded(geoms: FabricGeometry, params: SimParams, n_iters: int,
                 mesh, shard_axis: str, **kw) -> dict:
    """run_cells_hetero's ``mesh=`` entry: pad, run each shard on its
    device, concatenate and slice the padding off."""
    if shard_axis not in ("cell", "lane"):
        raise ValueError(f"shard_axis must be 'cell' or 'lane', "
                         f"got {shard_axis!r}")
    devices = mesh_devices(mesh)
    axis = 0 if shard_axis == "cell" else 1
    n_real = params.dt.shape[axis]
    if axis == 0:
        geoms = pad_batch(geoms, len(devices))
    params = pad_batch(params, len(devices), axis=axis)
    width = params.dt.shape[axis] // len(devices)
    outs = []
    for i, dev in enumerate(devices):
        lo, hi = i * width, (i + 1) * width
        g = geoms if axis == 1 else slice_batch(geoms, lo, hi)
        outs.append(run_cells_hetero(g, slice_batch(params, lo, hi, axis),
                                     n_iters, device=dev, **kw))
    return {k: np.concatenate([o[k] for o in outs], axis)
            .take(np.arange(n_real), axis) for k in outs[0]}


def _tree_map(fn, tree):
    """``fn`` on every array of a FabricGeometry, a SimParams or a dict of
    arrays (numpy or torch)."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return tree._map(fn)


def _leading_dim(tree, axis: int = 0) -> int:
    if isinstance(tree, dict):
        return next(iter(tree.values())).shape[axis]
    return (tree.caps_pad if isinstance(tree, FabricGeometry)
            else tree.dt).shape[axis]


def pad_batch(tree, multiple: int, axis: int = 0):
    """Pad every array's ``axis`` up to a multiple of ``multiple`` by
    repeating index 0 (a real cell: a padded cell runs redundant work and
    is sliced off, and it cannot change the real cells). A tree already
    at a multiple comes back as it is."""
    n = _leading_dim(tree, axis)
    target = -(-n // multiple) * multiple
    if target == n:
        return tree

    def pad(x):
        if isinstance(x, torch.Tensor):
            fill = x.narrow(axis, 0, 1).repeat_interleave(target - n, axis)
            return torch.cat([x, fill], axis)
        fill = np.repeat(np.take(np.asarray(x), [0], axis=axis),
                         target - n, axis=axis)
        return np.concatenate([np.asarray(x), fill], axis=axis)

    return _tree_map(pad, tree)


def slice_batch(tree, lo: int, hi: int, axis: int = 0):
    """Indices [lo, hi) of every array's ``axis``."""
    def cut(x):
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(lo, hi)
        return x[tuple(idx)]

    return _tree_map(cut, tree)


def hetero_cells(geoms: FabricGeometry, params: SimParams, device=None):
    """The G x S cells of :func:`run_cells_hetero` as the one batch it
    runs, on ``device``: each cell's geometry row
    (:meth:`FabricGeometry.take`) and its params, cells in (geometry,
    sub-cell) order. Returns ``(geometry, params)``."""
    G, S = params.dt.shape[:2]
    if not geoms.per_cell or geoms.paths.shape[0] != G:
        raise ValueError(f"params of {G} geometries x {S} sub-cells need "
                         f"a stack of {G} geometries")
    device = resolve_device(device)
    flat = params._map(lambda x: x.reshape(G * S, *x.shape[2:]))
    rows = torch.arange(G, device=device).repeat_interleave(S)
    return geoms.to(device).take(rows), flat.to(device)


def run_cell(geom: FabricGeometry, p: SimParams, n_iters: int, **kw) -> dict:
    """One unstacked cell through :func:`run_cells`; outputs lose the
    cell axis."""
    out = run_cells(geom, stack_params([p]), n_iters, **kw)
    return {k: v[0] for k, v in out.items()}


# --------------------------------------------------------------------------
# Result marshalling (host side)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SimResult:
    iter_times: np.ndarray  # (n_done - warmup,) seconds per victim iteration
    n_done: int
    mean_qdelay_s: float  # mean victim queueing delay per step
    victim_rate_trace: np.ndarray  # (T_sub,) aggregate victim goodput B/s
    time_trace: np.ndarray
    # False when the run finished too few iterations to discard the full
    # warmup prefix: iter_times then holds only the last iteration
    warmup_ok: bool = True


def _drop_warmup(times: np.ndarray, n_done: int, warmup: int):
    """Discard the warmup prefix; with fewer than warmup+1 iterations keep
    only the last one and report ``warmup_ok=False``."""
    if n_done > warmup:
        return times[warmup:], True
    return times[max(0, n_done - 1):], False


def summarize(out: dict, *, n_iters: int, warmup: int, dt: float,
              chunk: int, stride: int, cell: Optional[int] = None,
              job: int = 0) -> SimResult:
    """Build a :class:`SimResult` from (optionally batched) run outputs;
    ``job`` selects which job's completions to report."""
    pick = (lambda x: np.asarray(x)) if cell is None else \
        (lambda x: np.asarray(x)[cell])
    n_done = min(int(pick(out["it"])[job]), n_iters, TDONE_SLOTS)
    t_done = pick(out["t_done"])[job][:n_done]
    iter_times = np.diff(np.concatenate([[0.0], t_done]))
    iter_times, warmup_ok = _drop_warmup(iter_times, n_done, warmup)
    total_t = float(pick(out["t"])) or 1e-9
    n_valid = int(pick(out["chunks"])) * (chunk // stride)
    trace = pick(out["trace"])[:n_valid]
    return SimResult(
        iter_times=iter_times,
        n_done=n_done,
        mean_qdelay_s=float(pick(out["qd_acc"])) / total_t,
        victim_rate_trace=trace,
        time_trace=np.arange(n_valid) * stride * dt,
        warmup_ok=warmup_ok,
    )
