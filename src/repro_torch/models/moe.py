"""Mixture-of-Experts FFN of the port, as ``repro/models/moe.py``.

Token -> (expert, slot) dispatch with a per-shard capacity, expert
products accumulated in float32, and a combine that sums each token's k
picks in order. :func:`moe_ffn` runs the reference's four modes (``ep``,
``2d``, ``2d_full``, ``ep_sp``) on one rank of a (data, model) layout
(``launch/mesh.py``): ``rules`` (``layers.AxisRules``) says how the axes
split the expert leaves, ``groups`` (``layers.RankGroups``) holds the
rank's process groups. With tensor parallelism 1 the four modes compute
one function. Above 1 each follows the reference's ``shard_map`` body
(``repro/models/moe.py:139-325``) step for step:

* ``ep`` and ``2d``: the dispatch carries the rank's d-slice of the
  tokens, the up projection contracts it with those rows of the rank's
  f-columns and is completed by a sum over the TP ranks in the compute
  type, and the down projection is reduce-scattered over d. As in the
  reference this adds the TP ranks' different f-blocks together, so it is
  not the TP-1 function of the same weights: :func:`tp_fold` gives the
  weights whose TP-1 function it is;
* ``2d_full``: the full-d dispatch, each rank's f-slice completing its up
  projection; the down projection's partials are exchanged by one
  all-to-all and summed locally in the value's type, in rank order (the
  reference's ``_psum_scatter_bf16``);
* ``ep_sp``: the rank's slice of the sequence, the expert leaves gathered
  over the TP ranks each layer; ``ep`` when S does not split over them;
* in every mode the TP ranks' slices are gathered at the end, so every
  rank returns its whole (B, S, d).

Expert parallelism dispatches with two all-to-alls over the ``ep`` group
(``core.collectives.all_to_all``): the (E, C, d') buffer's expert blocks
go to their ranks and come back stacked (E_loc, ep * C, d'), then the
reverse. ``2d`` and ``2d_full`` gather FSDP-split leaves over that group.
Every cross-rank sum runs through ``core/collectives.py`` in a fixed
order (the ring all-reduce and reduce-scatter, whose adds are kernel 2),
with no float atomics; a dropped assignment is written to a slot C that is
cut off.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.models.layers import (ParamDecl, RankGroups,
                                       single_device_rules)

EP_MODES = ("ep", "ep_sp")
MODES = ("ep", "2d", "2d_full", "ep_sp")


EXPERT_LEAVES = ("w1", "w3", "w2")  # leaves with a leading expert axis


def expert_dims(cfg, rules=None):
    """(E_loc, d_loc, f_loc) of one rank's expert leaves under ``rules``
    (all of them without): w1 and w3 are (E_loc, d_loc, f_loc), w2 (E_loc,
    f_loc, d_loc). The reference's ``moe_decls``: ``ep``/``ep_sp`` split
    the experts over the ``ep`` axes, ``2d``/``2d_full`` split d over the
    FSDP axes when it divides; f splits over the TP axis when it
    divides."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    if rules is None:
        return E, d, f
    f_loc = f // rules.tp_size if rules.tp_if(f) else f
    if cfg.moe_sharding in EP_MODES:
        if E % rules.ep_size:
            raise ValueError(f"{E} experts do not split over "
                             f"{rules.ep_size} ranks")
        return E // rules.ep_size, d, f_loc
    fs = rules.fsdp_if(d)
    return E, d // rules.axis_size(fs) if fs else d, f_loc


def moe_decls(cfg, rules=None) -> dict:
    """The reference's declarations (router, then w1, w3, w2; w3 also when
    the activation is not swiglu), the expert leaves one rank's share
    under ``rules`` (:func:`expert_dims`)."""
    d = cfg.d_model
    E, d_loc, f = expert_dims(cfg, rules)
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    return {"router": ParamDecl((d, cfg.n_experts)),
            "w1": ParamDecl((E, d_loc, f)),
            "w3": ParamDecl((E, d_loc, f)),
            "w2": ParamDecl((E, f, d_loc), std=out_std)}


def _axes_index(rules, axes, coords) -> int:
    """The index of ``coords`` ({axis: index}) along ``axes``, the first
    axis major (a mesh axis tuple splits a dimension so)."""
    idx = 0
    for a in axes or ():
        idx = idx * rules.sizes[a] + coords[a]
    return idx


def rank_slices(cfg, rules, coords) -> dict:
    """{leaf: tuple of slices} cutting the global (E, d, f) / (E, f, d)
    expert leaves down to the share of the rank at ``coords`` ({axis:
    index} of the layout): the (E, d, f) -> (E_loc, d_loc, f_loc) slice
    that ``convert.lm_params_from_jax(weight_slices=...)`` applies."""
    E, d_loc, f_loc = expert_dims(cfg, rules)
    e0 = d0 = f0 = 0
    if cfg.moe_sharding in EP_MODES:
        e0 = _axes_index(rules, rules.ep, coords) * E
    elif d_loc != cfg.d_model:
        d0 = _axes_index(rules, rules.fsdp, coords) * d_loc
    if f_loc != cfg.d_ff:
        f0 = coords[rules.tp] * f_loc
    e, dd, ff = (slice(e0, e0 + E), slice(d0, d0 + d_loc),
                 slice(f0, f0 + f_loc))
    return {"w1": (e, dd, ff), "w3": (e, dd, ff), "w2": (e, ff, dd)}


def tp_fold(p: dict, cfg, tp: int) -> dict:
    """The one-rank weights whose TP-1 :func:`moe_ffn` is the ``ep``/``2d``
    function at tensor parallelism ``tp`` of the whole weights ``p``. The
    reference's d-sliced up projection adds rank r's rows d_r of its
    columns f_r, so w1 and w3 become (E, d, f / tp) with rows d_r taken
    from columns f_r; its down projection is reduce-scattered over the
    ranks' rows f_r of w2, so w2 becomes (E, f / tp, d), the sum of its tp
    row blocks in rank order. Where f does not split, each rank holds all
    of w2 and the sum counts it tp times. ``2d_full`` and ``ep_sp``
    compute the TP-1 function: ``p`` as it is."""
    if tp == 1 or cfg.moe_sharding in ("2d_full", "ep_sp"):
        return dict(p)
    d, f = cfg.d_model, cfg.d_ff
    dl, fl = d // tp, (f // tp if f % tp == 0 else f)
    out = dict(p)
    if fl != f:
        for k in ("w1", "w3"):
            out[k] = torch.cat([p[k][:, r * dl:(r + 1) * dl,
                                     r * fl:(r + 1) * fl]
                                for r in range(tp)], dim=1)
    blocks = [p["w2"][:, r * fl:(r + 1) * fl] if fl != f else p["w2"]
              for r in range(tp)]
    w2 = blocks[0]
    for b in blocks[1:]:
        w2 = w2 + b
    out["w2"] = w2
    return out


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
    counts = _counts(flat_e, E)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=gates.device) - starts[flat_e[order]]
    pos = torch.empty_like(pos_sorted).index_copy_(0, order, pos_sorted)
    slot = torch.where(pos < capacity, pos, torch.full_like(pos, capacity))
    return flat_e, slot, topv.reshape(-1)


def _counts(flat_e, E: int):
    """Assignments an expert, int64 (E,): integer adds, so exact in any
    order; unlike ``bincount`` it runs on meta tensors."""
    return torch.zeros(E, dtype=torch.int64, device=flat_e.device
                       ).scatter_add_(0, flat_e, torch.ones_like(flat_e))


def _aux_loss(gates, flat_e, top_k: int):
    """Switch-style load-balancing loss of one shard (the caller takes the
    mean over shards)."""
    T, E = gates.shape
    frac = _counts(flat_e, E).float() / (T * top_k)
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
    grad = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if (a.is_cuda or a.is_meta) and not grad:  # meta: the card's path
        return torch.bmm(a, b, out_dtype=torch.float32)
    # the out_dtype product has no derivative
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


def _gather(t, group, dim: int):
    """The group's ranks' ``t`` joined along ``dim`` in rank order (the
    reference's tiled ``all_gather``)."""
    if collectives.group_size(group) == 1:
        return t
    return torch.cat(list(collectives.all_gather(t, group).unbind(0)),
                     dim=dim)


def _psum_scatter_bf16(o, group):
    """The reference's ``_psum_scatter_bf16``: o (E, C, d) summed over the
    group's ranks and split over d, rank r keeping slice r. One all-to-all
    moves the n d-slices in o's own type, then the n partials are summed
    here in that type, in rank order."""
    n = collectives.group_size(group)
    E, C, d = o.shape
    parts = collectives.all_to_all(
        o.reshape(E, C, n, d // n).permute(2, 0, 1, 3), group)
    out = parts[0]
    for j in range(1, n):
        out = out + parts[j]
    return out


def moe_ffn(x, p, cfg, *, rules=None, groups=None):
    """The MoE FFN on x (B, S, d), this rank's tokens (every rank of a TP
    group holds the same). ``p`` holds ``router`` (d, E) and the expert
    leaves ``w1``/``w3`` (E', d', f'), ``w2`` (E', f', d'): this rank's
    share under ``rules`` (:func:`expert_dims`; all of them without a
    group). ``groups`` (``layers.RankGroups``) are the rank's ``dp``,
    ``ep`` and ``tp`` groups, ``rules`` the layout's axis rules (default
    the host layout of the groups' sizes). Returns (out (B, S, d) in x's
    type, the aux loss averaged over the shards, float32)."""
    if cfg.moe_sharding not in MODES:
        raise ValueError(f"moe_sharding must be one of {MODES}, got "
                         f"{cfg.moe_sharding!r}")
    groups = groups or RankGroups()
    n_dp, n_ep, tp = (collectives.group_size(g)
                      for g in (groups.dp, groups.ep, groups.tp))
    if rules is None:
        rules = single_device_rules(n_ep, tp)
    if (rules.dp_size, rules.ep_size, rules.tp_size) != (n_dp, n_ep, tp):
        raise ValueError(
            f"rules split dp/ep/tp {rules.dp_size}/{rules.ep_size}/"
            f"{rules.tp_size} ways, the groups hold {n_dp}/{n_ep}/{tp} "
            "ranks")
    E, k, d = cfg.n_experts, cfg.top_k, cfg.d_model
    cdt = getattr(torch, cfg.compute_dtype)
    mode = cfg.moe_sharding
    B, S, _ = x.shape
    sp = mode == "ep_sp" and S % tp == 0
    if mode == "ep_sp" and not sp:
        mode = "ep"  # the reference's fall-back: its weight layout is ep's
    ep = n_ep if mode in EP_MODES else 1
    r = collectives.group_rank(groups.tp)
    want = expert_dims(cfg, rules)
    if tuple(p["w1"].shape) != want:
        raise ValueError(f"w1 is {tuple(p['w1'].shape)}, this rank's share "
                         f"is {want}")
    S_loc = S // tp if sp else S
    T = B * S_loc
    xf = (x[:, r * S_loc:(r + 1) * S_loc] if sp else x).reshape(T, d)
    # operands in x's type, float32 accumulation
    gates = F.softmax(_bmm_f32(xf[None], p["router"].to(xf.dtype)[None])[0],
                      dim=-1)
    C = capacity(T, cfg)
    flat_e, slot, comb_w = _dispatch_indices(gates, k, C)
    aux = _aux_loss(gates, flat_e, k)
    if sp and tp > 1:
        aux = collectives.all_mean(aux, groups.tp)
    if n_dp > 1:
        aux = collectives.all_mean(aux, groups.dp)
    tok = torch.arange(T * k, device=x.device) // k

    def dispatch(rows):
        """Token rows into (E, C + 1, d'); slot C takes the dropped."""
        buf = rows.new_zeros((E, C + 1, rows.shape[1]), dtype=cdt)
        buf.index_put_((flat_e, slot), rows[tok].to(cdt))
        return buf[:, :C]

    def to_experts(buf):
        """Expert block j to rank j; back stacked (E_loc, ep * C, d')."""
        if ep == 1:
            return buf
        got = collectives.all_to_all(
            buf.reshape(ep, E // ep, C, buf.shape[-1]), groups.ep)
        return got.transpose(0, 1).reshape(E // ep, ep * C, buf.shape[-1])

    def from_experts(o):
        """Rank j's C slots of each local expert back to rank j."""
        if ep == 1:
            return o
        sent = o.reshape(E // ep, ep, C, o.shape[-1]).transpose(0, 1)
        return collectives.all_to_all(sent, groups.ep).reshape(
            E, C, o.shape[-1])

    def combine(o):
        """Each assignment's row times its weight; the k picks summed in
        order (slot C, a zero row, for the dropped). (T, d')."""
        dd = o.shape[-1]
        o_pad = torch.cat([o, o.new_zeros((E, 1, dd))], dim=1)
        picked = (o_pad[flat_e, slot] * comb_w[:, None].to(o.dtype)
                  ).reshape(T, k, dd)
        out = picked[:, 0]
        for j in range(1, k):
            out = out + picked[:, j]
        return out

    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    if mode in ("2d", "2d_full") and w1.shape[1] != d:  # FSDP-split d
        w1, w3 = _gather(w1, groups.ep, 1), _gather(w3, groups.ep, 1)
        w2 = _gather(w2, groups.ep, 2)
    if mode == "ep_sp":
        # whole d, the leaves gathered over TP each layer; a2a over ep
        w1, w3 = _gather(w1, groups.tp, 2), _gather(w3, groups.tp, 2)
        w2 = _gather(w2, groups.tp, 1)
        o = from_experts(_experts(to_experts(dispatch(xf)), w1, w3, w2,
                                  cfg.act, cdt))
        out = combine(o).reshape(B, S_loc, d)
        return _gather(out, groups.tp, 1).to(x.dtype), aux
    if mode == "2d_full":
        o = _experts(dispatch(xf), w1, w3, w2, cfg.act, cdt)
        if tp > 1:
            o = _psum_scatter_bf16(o, groups.tp)
        out = _gather(combine(o), groups.tp, 1)
        return out.reshape(B, S, d).to(x.dtype), aux

    # ep / 2d: d-sliced dispatch, the up projection summed over TP in the
    # compute type, the down projection reduce-scattered over d
    dl = d // tp
    buf = to_experts(dispatch(xf[:, r * dl:(r + 1) * dl]))
    h1 = _bmm_f32(buf, w1[:, r * dl:(r + 1) * dl].to(cdt))
    h3 = _bmm_f32(buf, w3[:, r * dl:(r + 1) * dl].to(cdt)) \
        if cfg.act == "swiglu" else None
    del buf
    if tp > 1:
        h = torch.cat([h1, h3], dim=-1) if h3 is not None else h1
        h = collectives.psum(h.to(cdt), groups.tp)
        h1, h3 = (h.chunk(2, dim=-1) if h3 is not None else (h, None))
    hh = _activate(h1, h3, cfg.act).to(cdt)
    del h1, h3
    o = _bmm_f32(hh, w2.to(cdt)).to(cdt)
    if tp > 1:
        o = collectives.psum_scatter(o, groups.tp, dim=2)
    out = _gather(combine(from_experts(o)), groups.tp, 1)
    return out.reshape(B, S, d).to(x.dtype), aux
