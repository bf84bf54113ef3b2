"""Custom collective schedules over point-to-point primitives, as
``repro/core/collectives.py``.

The paper (§III-B) implements ring AllGather and linear AlltoAll over MPI
send/recv so that the algorithm is the same on every system. The
reference writes the schedules as ``jax.lax.ppermute`` step sequences
inside ``shard_map``; here they run on the ranks of a ``torch.distributed``
process group (``launch.mesh.spawn_group``), each rank calling the
schedule with its own shard. :func:`ppermute` is the twin of
``jax.lax.ppermute``: every send and receive of one step go in one
``batch_isend_irecv``, and a rank that no pair sends to receives zeros.
The ring AllReduce (ReduceScatter + AllGather) is the paper's Fig. 1
custom implementation; its accumulate step takes the ``add=`` hook, where
the fused kernel (kernel 2, :func:`fused_add`) plugs in.

Each schedule keeps the reference's order of additions, so float32
results are bit-equal to JAX's. A schedule reads its rank and the group's
size from ``group`` (``None``: the default group).

Transport: PyTorch's backend table lists gloo's point-to-point,
all_gather and all_to_all as host-memory only. On the card (torch 2.11)
gloo's all_gather and all_to_all took CUDA tensors (they stage inside
gloo), so :func:`all_gather` and :func:`all_to_all` pass them as they
are; its point-to-point does not, so :func:`ppermute` on a gloo group
moves a CUDA tensor to the host and back in :func:`stage`, which counts
the bytes it moves in ``staged_bytes``. On nccl, or for a CPU tensor,
nothing is staged.

A :class:`StandInGroup` moves nothing: the dry run (``launch/dryrun.py``)
gives it to one rank's program on meta tensors, and each collective called
on it records its kind, operand and result bytes and group size, the
gradient's collective too when a backward runs through it.
"""
from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import ops

staged_bytes = 0  # bytes staged device -> host -> device since import


# the collective a gradient takes through each kind (its transpose)
_TRANSPOSE = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
              "all-reduce": "all-reduce", "all-to-all": "all-to-all",
              "collective-permute": "collective-permute"}


class StandInGroup:
    """A group of ``size`` ranks for counting one rank's program: every
    collective on it appends ``{"kind", "operand_bytes", "result_bytes",
    "group_size"}`` (the kinds of the reference's ``hlo_stats``) to
    ``records`` and returns an uninitialised meta tensor of the result's
    shape. This rank is ``rank``. Meta tensors only."""

    def __init__(self, size: int, rank: int = 0, records=None):
        self.size, self.rank = int(size), int(rank)
        self.records = records if records is not None else []

    def record(self, kind: str, operand: torch.Tensor, result_shape):
        item = operand.element_size()
        self.records.append({
            "kind": kind, "operand_bytes": operand.numel() * item,
            "result_bytes": int(np.prod(result_shape, dtype=np.int64))
            * item, "group_size": self.size, "site": caller()})


_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_MODULES: dict = {}  # file -> "models.moe", or "" outside the package


def caller(*skip: str) -> str:
    """``module.function`` of the innermost ``repro_torch`` frame on the
    stack outside this module and the files ``skip`` (a record's site,
    ``launch.hlo_stats``' row names); "" if there is none."""
    f = sys._getframe(1)
    while f is not None:
        fn = f.f_code.co_filename
        mod = _MODULES.get(fn)
        if mod is None:
            path = os.path.abspath(fn)
            mod = (os.path.relpath(path, _PKG)[:-3].replace(os.sep, ".")
                   if path.startswith(_PKG + os.sep) else "")
            _MODULES[fn] = mod
        if mod and fn != __file__ and fn not in skip:
            return f"{mod}.{f.f_code.co_name}"
        f = f.f_back
    return ""


class _StandIn(torch.autograd.Function):
    """A collective on a :class:`StandInGroup`: recorded, nothing moved;
    its backward records the gradient's collective."""

    @staticmethod
    def forward(ctx, x, group, kind, shape):
        if x.device.type != "meta":
            raise ValueError("a stand-in group moves nothing: meta tensors "
                             f"only, got {x.device}")
        group.record(kind, x, shape)
        ctx.args = (group, kind, tuple(x.shape))
        return x.new_empty(shape)

    @staticmethod
    def backward(ctx, g):
        group, kind, shape = ctx.args
        group.record(_TRANSPOSE[kind], g, shape)
        return g.new_empty(shape), None, None, None


def _stand_in(x, group, kind, shape):
    return _StandIn.apply(x, group, kind, tuple(shape))


def group_size(group) -> int:
    """The ranks of ``group``; ``None`` is one rank (a model's groups)."""
    if group is None:
        return 1
    if isinstance(group, StandInGroup):
        return group.size
    return dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in ``group``; 0 in ``None``."""
    if group is None:
        return 0
    if isinstance(group, StandInGroup):
        return group.rank
    return dist.get_rank(group)


def _fwd(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _bwd(n: int):
    return [(i, (i - 1) % n) for i in range(n)]


def _size_rank(group):
    if isinstance(group, StandInGroup):
        return group.size, group.rank
    return dist.get_world_size(group), dist.get_rank(group)


def _peer(group, r: int) -> int:
    """The global rank of group rank ``r``."""
    return r if group is None else dist.get_global_rank(group, r)


def stage(x: torch.Tensor, group, op: Callable) -> torch.Tensor:
    """``op(x on the wire's device) -> result`` with the result on
    ``x``'s device. On a gloo group a CUDA tensor is copied to the host,
    the operation runs there and its result is copied back; both copies
    are counted in ``staged_bytes``. Otherwise ``op(x)`` as it is."""
    global staged_bytes
    if x.device.type != "cuda" or dist.get_backend(group) != "gloo":
        return op(x)
    host = x.cpu()
    out = op(host)
    staged_bytes += host.numel() * host.element_size() \
        + out.numel() * out.element_size()
    return out.to(x.device)


# --------------------------------------------------------------------------
# Primitives
# --------------------------------------------------------------------------


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """The twin of ``jax.lax.ppermute``: for each ``(src, dst)`` of
    ``perm`` (group ranks), rank src's ``x`` arrives at rank dst. Returns
    what this rank received, zeros where no pair sends to it."""
    n, rank = _size_rank(group)
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "collective-permute", x.shape)
    mine = [(s, d) for s, d in perm if rank in (s, d)]
    if not mine:
        return torch.zeros_like(x)

    def run(v):
        v = v.contiguous()
        out = torch.zeros_like(v)
        ops = []
        for src, dst in mine:
            if src == dst:
                out.copy_(v)
            elif src == rank:
                ops.append(dist.P2POp(dist.isend, v, _peer(group, dst),
                                      group))
            else:
                ops.append(dist.P2POp(dist.irecv, out, _peer(group, src),
                                      group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return out

    return stage(x, group, run)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: (n,) + x.shape (the
    one-shot ``jax.lax.all_gather``)."""
    n, _ = _size_rank(group)
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "all-gather", (n,) + tuple(x.shape))
    flat = x.reshape(-1).contiguous()
    out = flat.new_empty(n * flat.numel())
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((n,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): chunk j goes to rank j; returns (n, ...) whose chunk j
    came from rank j (``jax.lax.all_to_all`` tiled on axis 0)."""
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "all-to-all", x.shape)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, summed in rank order (the
    twin of ``jax.lax.pmean``; every rank gets the same bits)."""
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "all-reduce", x.shape)
    parts = all_gather(x, group)
    total = parts[0]
    for i in range(1, parts.shape[0]):
        total = total + parts[i]
    # a true division (on the card PyTorch multiplies by the reciprocal
    # of a Python scalar)
    return total / torch.tensor(float(parts.shape[0]), dtype=total.dtype,
                                device=total.device)


# --------------------------------------------------------------------------
# Ring AllGather (the paper's custom AllGather)
# --------------------------------------------------------------------------


def ring_all_gather(x: torch.Tensor, group=None, *,
                    bidirectional: bool = False) -> torch.Tensor:
    """x: this rank's shard (d, ...). Returns (n, d, ...) in rank order.
    ``bidirectional`` sends half the steps each way round the ring."""
    n, rank = _size_rank(group)
    if n == 1:
        return x[None]
    out = x.new_empty((n,) + tuple(x.shape))
    out[rank] = x
    if not bidirectional:
        cur = x
        for j in range(1, n):  # after step j: the shard of rank - j
            cur = ppermute(cur, group, _fwd(n))
            out[(rank - j) % n] = cur
        return out
    fw = bw = x
    for j in range(1, n // 2 + 1):  # (n - 1 + 1) // 2 steps forward
        fw = ppermute(fw, group, _fwd(n))
        out[(rank - j) % n] = fw
    for j in range(1, (n - 1) // 2 + 1):
        bw = ppermute(bw, group, _bwd(n))
        out[(rank + j) % n] = bw
    return out


# --------------------------------------------------------------------------
# Ring ReduceScatter / AllReduce (paper Fig. 1 custom ring AllReduce)
# --------------------------------------------------------------------------


def fused_add(acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``acc + x`` through kernel 2 (``ops.fused_accumulate``; its plain
    version on the CPU), on chunks of any shape: the ``add=`` hook of the
    ring schedules."""
    two_d = (1, -1) if acc.dim() < 2 else (-1, acc.shape[-1])
    return ops.fused_accumulate(acc.reshape(two_d).contiguous(),
                                x.reshape(two_d).contiguous()
                                ).reshape(acc.shape)


def ring_reduce_scatter(x: torch.Tensor, group=None,
                        add: Optional[Callable] = None) -> torch.Tensor:
    """x: (n, d, ...) this rank's full buffer. Returns this rank's chunk
    summed over the ranks: n - 1 steps, each a forward send and one
    ``add(received, own chunk)``."""
    n, rank = _size_rank(group)
    if n == 1:
        return x[0]
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "reduce-scatter", x.shape[1:])
    add = add or (lambda a, b: a + b)
    acc = x[(rank - 1) % n]
    for s in range(1, n):
        acc = ppermute(acc, group, _fwd(n))
        acc = add(acc, x[(rank - 1 - s) % n])
    return acc


def ring_all_reduce(x: torch.Tensor, group=None,
                    add: Optional[Callable] = None) -> torch.Tensor:
    """x: (n, d, ...). Returns (n, d, ...) summed over the ranks (RS +
    AG)."""
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "all-reduce", x.shape)
    return ring_all_gather(ring_reduce_scatter(x, group, add), group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks, every rank the same bits (the
    twin of ``jax.lax.psum``): the ring all-reduce of x flattened into n
    zero-padded chunks, its adds through kernel 2 (:func:`fused_add`)."""
    n = group_size(group)
    if n == 1:
        return x
    if isinstance(group, StandInGroup):
        return _stand_in(x, group, "all-reduce", x.shape)
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    out = ring_all_reduce(flat.reshape(n, -1), group, add=fused_add)
    return out.reshape(-1)[:x.numel()].reshape(x.shape)


def psum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x summed over the group's ranks and split along ``dim`` into n
    slices, this rank keeping its own (the twin of ``jax.lax.psum_scatter``
    tiled): the ring reduce-scatter, its adds through kernel 2."""
    n = group_size(group)
    if n == 1:
        return x
    parts = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    return ring_reduce_scatter(parts.contiguous(), group, add=fused_add)


# --------------------------------------------------------------------------
# AlltoAll: linear (paper) and pairwise schedules
# --------------------------------------------------------------------------


def linear_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The paper's 'linear' algorithm, a direct exchange (one
    ``all_to_all_single``). x: (n, d, ...)."""
    n, _ = _size_rank(group)
    return x if n == 1 else all_to_all(x, group)


def pairwise_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """n - 1 ppermute rounds; round s sends to rank + s and receives
    from rank - s."""
    n, rank = _size_rank(group)
    out = torch.zeros_like(x)
    out[rank] = x[rank]
    for s in range(1, n):
        perm = [(i, (i + s) % n) for i in range(n)]
        out[(rank - s) % n] = ppermute(x[(rank + s) % n], group, perm)
    return out


# --------------------------------------------------------------------------
# Incast (the paper's edge-congestion aggressor pattern)
# --------------------------------------------------------------------------


def incast_gather(x: torch.Tensor, group=None, root: int = 0
                  ) -> torch.Tensor:
    """Linear fan-in of every rank's buffer to ``root``, one sender a
    step. Returns (n, d, ...): every rank's buffer at the root, zeros
    elsewhere."""
    n, rank = _size_rank(group)
    out = x.new_zeros((n,) + tuple(x.shape))
    if rank == root:
        out[root] = x
    for s in range(1, n):
        src = (root + s) % n
        rec = ppermute(x, group, [(src, root)])
        if rank == root:
            out[src] = rec
    return out


# --------------------------------------------------------------------------
# Runner + analytic wire-byte model (autotuner/roofline)
# --------------------------------------------------------------------------

SCHEDULES = {"ring_all_gather": ring_all_gather,
             "ring_reduce_scatter": ring_reduce_scatter,
             "ring_all_reduce": ring_all_reduce,
             "linear_all_to_all": linear_all_to_all,
             "pairwise_all_to_all": pairwise_all_to_all,
             "incast_gather": incast_gather}


def _run_schedule(ctx, name, shards, kw):
    x = torch.as_tensor(shards[ctx.rank], device=ctx.device)
    return SCHEDULES[name](x, None, **kw).cpu().numpy()


def run_on_group(name: str, shards, *, backend: str = "gloo",
                 device="cuda", **kw) -> list:
    """The twin of ``run_on_mesh``: run the schedule ``name`` on
    ``len(shards)`` spawned ranks (``launch.mesh.spawn_group``), rank r
    on ``shards[r]`` (numpy), and return each rank's output as numpy, in
    rank order. ``kw`` goes to the schedule (``bidirectional``, ``root``;
    an ``add`` hook must be a module-level function)."""
    from repro_torch.launch.mesh import spawn_group
    shards = [np.asarray(s) for s in shards]
    return spawn_group(_run_schedule, len(shards), backend=backend,
                       device=device, args=(name, shards, kw))


def wire_bytes_model(kind: str, n: int, vector_bytes: float) -> dict:
    """Per-rank wire bytes + serialized step count for each schedule."""
    v = float(vector_bytes)
    if n <= 1:
        return {"bytes": 0.0, "steps": 0}
    if kind == "ring_all_gather":
        return {"bytes": (n - 1) / n * v, "steps": n - 1}
    if kind == "bidir_ring_all_gather":
        return {"bytes": (n - 1) / n * v, "steps": (n - 1 + 1) // 2}
    if kind == "ring_all_reduce":
        return {"bytes": 2 * (n - 1) / n * v, "steps": 2 * (n - 1)}
    if kind in ("linear_all_to_all", "pairwise_all_to_all"):
        return {"bytes": (n - 1) / n * v,
                "steps": 1 if kind == "linear_all_to_all" else n - 1}
    if kind == "incast":
        return {"bytes": v, "steps": n - 1}
    raise KeyError(kind)
