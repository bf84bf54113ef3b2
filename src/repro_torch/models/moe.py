"""Mixture-of-Experts FFN of the port, as ``repro/models/moe.py``.

Token -> (expert, slot) dispatch with a per-shard capacity, expert
products accumulated in float32, and a combine that sums each token's k
picks in order. The reference's four modes (``ep``, ``2d``, ``2d_full``,
``ep_sp``) compute one function when tensor parallelism is 1: that
function is :func:`moe_ffn` on one device. Expert parallelism (``ep`` and
``ep_sp`` over a ``torch.distributed`` group of more than one rank)
dispatches with two all-to-alls (``core.collectives.all_to_all``), each
rank holding its slice of the experts (``expert_slice``), in the
reference's layouts: the (E, C, d) buffer's expert blocks go to their
ranks and come back stacked (E_loc, ep * C, d), then the reverse.
Tensor parallelism above 1 (and so the reference's ``_psum_scatter_bf16``)
is not ported (ROADMAP Queue 1, item 15).

Deterministic: a stable sort of the assignments, integer expert counts,
dropped assignments written to a slot C that is cut off, no float atomics.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.models.layers import ParamDecl

EP_MODES = ("ep", "ep_sp")
MODES = ("ep", "2d", "2d_full", "ep_sp")


EXPERT_LEAVES = ("w1", "w3", "w2")  # leaves with a leading expert axis


def moe_decls(cfg, ep: int = 1) -> dict:
    """The reference's declarations (router, then w1, w3, w2; w3 also when
    the activation is not swiglu), with E / ``ep`` experts in the expert
    leaves: one rank's share under expert parallelism."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts // ep
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    return {"router": ParamDecl((d, cfg.n_experts)),
            "w1": ParamDecl((E, d, f)),
            "w3": ParamDecl((E, d, f)),
            "w2": ParamDecl((E, f, d), std=out_std)}


def expert_slice(n_experts: int, rank: int, size: int) -> slice:
    """The experts rank ``rank`` of an EP group of ``size`` holds."""
    if n_experts % size:
        raise ValueError(f"{n_experts} experts do not split over {size} "
                         "ranks")
    e = n_experts // size
    return slice(rank * e, (rank + 1) * e)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def capacity(n_tokens: int, cfg) -> int:
    """Slots an expert takes from a shard of ``n_tokens`` tokens:
    max(8, round_up(ceil(T * k / E * cf), 8))."""
    return max(8, _round_up(int(np.ceil(
        n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), 8))


def _dispatch_indices(gates, top_k: int, capacity: int):
    """Token -> (expert, slot) with per-shard capacity. gates (T, E).
    Returns (flat_e (N,), slot (N,), combine_w (N,)), N = T * top_k, slot
    == capacity for dropped assignments. The top k are taken as
    ``lax.top_k`` takes them (larger first, the lower expert on a tie);
    an assignment's slot is the number of earlier assignments (token
    order, then pick order) to the same expert."""
    T, E = gates.shape
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :top_k], topi[:, :top_k]
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    flat_e = topi.reshape(-1)
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=gates.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    slot = torch.where(pos < capacity, pos, torch.full_like(pos, capacity))
    return flat_e, slot, topv.reshape(-1)


def _aux_loss(gates, flat_e, top_k: int):
    """Switch-style load-balancing loss of one shard (the caller takes the
    mean over shards)."""
    T, E = gates.shape
    frac = torch.bincount(flat_e, minlength=E).float() / (T * top_k)
    return E * torch.sum(frac * gates.float().mean(dim=0))


def _activate(h1, h3, act: str):
    """The reference's ``_activate`` of h = [h1, h3] (h3 only for swiglu),
    float32; without a gradient in h1's storage: the (E', C', 2f)
    concatenation the reference builds is ~6.7 GB at grok-1's serve
    prefill."""
    if h1.requires_grad:
        if act == "swiglu":
            return F.silu(h1) * h3
        return torch.square(F.relu(h1)) if act == "relu2" \
            else F.gelu(h1, approximate="tanh")
    if act == "swiglu":
        return F.silu(h1, inplace=True).mul_(h3)
    if act == "relu2":
        return F.relu(h1, inplace=True).square_()
    return F.gelu(h1, approximate="tanh")


def _bmm_f32(a, b):
    """a @ b per expert, float32 out of float32 accumulation (the
    reference's ``preferred_element_type=jnp.float32``). A product of two
    bfloat16 values is exact in float32, so the CPU's route through
    float32 operands computes the same function."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _experts(buf, w1, w3, w2, act: str, cdt):
    """(E', C', d) buffer -> (E', C', d) expert outputs in ``cdt``: the
    up projections and h in float32, the activation rounded to ``cdt``,
    the down projection accumulated in float32 and rounded."""
    h1 = _bmm_f32(buf, w1.to(cdt))
    h3 = _bmm_f32(buf, w3.to(cdt)) if act == "swiglu" else None
    hh = _activate(h1, h3, act).to(cdt)
    del h1, h3
    return _bmm_f32(hh, w2.to(cdt)).to(cdt)


def moe_ffn(x, p, cfg, *, group=None, tp_size: int = 1):
    """The MoE FFN on x (B, S, d), this shard's tokens. ``p`` holds
    ``router`` (d, E) and ``w1``/``w3`` (E', d, f), ``w2`` (E', f, d):
    all E experts, or under expert parallelism (an ``ep``/``ep_sp``
    config and a ``group`` of more than one rank) this rank's
    ``expert_slice``. Returns (out (B, S, d) in x's type, the aux loss
    averaged over the group's shards, float32)."""
    if tp_size != 1:
        raise NotImplementedError(
            "tensor-parallel MoE (d_ff split over ranks, the reference's "
            "_psum_scatter_bf16) is not ported: ROADMAP Queue 1, item 15")
    if cfg.moe_sharding not in MODES:
        raise ValueError(f"moe_sharding must be one of {MODES}, got "
                         f"{cfg.moe_sharding!r}")
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    cdt = getattr(torch, cfg.compute_dtype)
    n_shards = 1 if group is None else dist.get_world_size(group)
    ep = n_shards if cfg.moe_sharding in EP_MODES else 1
    B, S, _ = x.shape
    T = B * S
    xf = x.reshape(T, d)
    # operands in x's type, float32 accumulation
    gates = F.softmax(_bmm_f32(xf[None], p["router"].to(xf.dtype)[None])[0],
                      dim=-1)
    C = capacity(T, cfg)
    flat_e, slot, comb_w = _dispatch_indices(gates, k, C)
    aux = _aux_loss(gates, flat_e, k)
    if n_shards > 1:
        aux = collectives.all_mean(aux, group)

    # dispatch: token rows into (E, C + 1, d); slot C takes the dropped
    tok = torch.arange(T * k, device=x.device) // k
    buf = xf.new_zeros((E, C + 1, d), dtype=cdt)
    buf.index_put_((flat_e, slot), xf[tok].to(cdt))
    buf = buf[:, :C]
    if p["w1"].shape[0] * ep != E:
        raise ValueError(f"w1 holds {p['w1'].shape[0]} experts, not "
                         f"{E} // {ep}")
    if ep > 1:
        E_loc = E // ep
        # expert block j to rank j; back stacked (E_loc, ep * C, d)
        got = collectives.all_to_all(buf.reshape(ep, E_loc, C, d), group)
        buf = got.transpose(0, 1).reshape(E_loc, ep * C, d)
    o = _experts(buf, p["w1"], p["w3"], p["w2"], cfg.act, cdt)
    if ep > 1:
        # rank j's C slots of each local expert back to rank j
        sent = o.reshape(E_loc, ep, C, d).transpose(0, 1)
        o = collectives.all_to_all(sent, group).reshape(E, C, d)

    # combine: each assignment's row times its weight; the k picks summed
    # in order (slot C, a zero row, for the dropped)
    o_pad = torch.cat([o, o.new_zeros((E, 1, d))], dim=1)
    picked = (o_pad[flat_e, slot] * comb_w[:, None].to(o.dtype)
              ).reshape(T, k, d)
    out = picked[:, 0]
    for j in range(1, k):
        out = out + picked[:, j]
    return out.reshape(B, S, d).to(x.dtype), aux
