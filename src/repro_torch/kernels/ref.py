"""Plain PyTorch versions of the hand-written kernels.

Each function here is the kernel's specification: the CPU path runs it,
and ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def _up(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 kept as it is (gradient checks run in float64)."""
    return t if t.dtype == torch.float64 else t.float()


def fused_accumulate(acc: torch.Tensor, x: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """Ring-AllReduce receive-accumulate: ``acc + scale * x`` in float32
    whatever the input types, rounded to ``acc.dtype`` (paper Fig. 1).
    Follows ``repro/kernels/ref.py::fused_accumulate``."""
    return (acc.float() + scale * x.float()).to(acc.dtype)


def _attn_scores(q, k, causal: bool, window: int, dtype=torch.float32):
    """Scaled scores (B, KH, G, Sq, Skv) in ``dtype`` with masked pairs at
    -inf, and the live mask (Sq, Skv)."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KH, H // KH, D).to(dtype)
    s = torch.einsum("bqkgd,bckd->bkgqc", qr, k.to(dtype)) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones(Sq, Skv, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= kv_pos > q_pos - window
    return s.masked_fill(~mask, -math.inf), mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """Full-matrix GQA attention in float32, the output in ``q.dtype``.

    q: (B, Sq, H, D); k, v: (B, Skv, KH, D); query head ``h`` reads KV head
    ``h // (H // KH)``; scale 1/sqrt(D). Follows
    ``repro/kernels/ref.py::flash_attention`` with the window mask of
    ``repro/models/layers.py::flash_attention_xla``: ``window`` > 0 also
    masks ``kv_pos <= q_pos - window``. A row with every key masked gives
    0, as the kernels' guards (``m_safe``, ``l >= 1e-30``) do. With
    ``return_lse`` it also returns each row's log-sum-exp of its scaled
    scores, (B, H, Sq) float32, -inf for a row with no live key."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    s, _ = _attn_scores(q, k, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(s - m_safe)
    o = torch.einsum("bkgqc,bckd->bqkgd", p, v.float())
    l = p.sum(dim=-1)  # (B, KH, G, Sq)
    o = o / l.permute(0, 3, 1, 2)[..., None].clamp_min(1e-30)
    o = o.reshape(B, Sq, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.where(l > 0, m[..., 0] + torch.log(l), -math.inf)
    return o, lse.reshape(B, H, Sq)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        dtype=torch.float32):
    """(dq, dk, dv) of :func:`flash_attention`, each in its input's type,
    from the forward's output ``o`` and row log-sum-exp ``lse`` (B, H, Sq)
    and the output gradient ``do``; the specification of the backward
    kernel (``csrc/flash_attention_bwd.cu``). In float32, with the S x S
    matrices written out: P = exp(s - lse) on the live pairs (0 elsewhere,
    and for a row with no live key), delta = rowsum(dO * O),
    dS = P * (dO . V - delta); dV = P^T dO, dK = dS^T q / sqrt(D),
    dQ = dS K / sqrt(D), summed over the G query heads of a KV head.
    ``dtype`` float64 evaluates the same function with float64 products
    and sums (to hold a kernel where float32's own rounding over long sums
    reaches a check's limit)."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    s, mask = _attn_scores(q, k, causal, window, dtype)
    lse5 = lse.reshape(B, KH, G, Sq, 1).to(dtype)
    live = mask & torch.isfinite(lse5)
    p = torch.where(live, torch.exp(s - torch.where(live, lse5, 0.0)), 0.0)
    do5 = do.reshape(B, Sq, KH, G, D).to(dtype)
    delta = (do5 * o.reshape(B, Sq, KH, G, D).to(dtype)).sum(-1)  # b q k g
    dp = torch.einsum("bqkgd,bckd->bkgqc", do5, v.to(dtype))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / math.sqrt(D)
    dv = torch.einsum("bkgqc,bqkgd->bckd", p, do5)
    dk = torch.einsum("bkgqc,bqkgd->bckd", ds,
                      q.reshape(B, Sq, KH, G, D).to(dtype)) * scale
    dq = torch.einsum("bkgqc,bckd->bqkgd", ds, k.to(dtype)) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def fused_selective_scan(dt: torch.Tensor, A: torch.Tensor,
                         B_coef: torch.Tensor, C_coef: torch.Tensor,
                         x: torch.Tensor, h0: torch.Tensor):
    """Mamba selective scan, a loop over time.

    dt, x: (B, T, Di); A: (Di, N); B_coef, C_coef: (B, T, N); h0: (B, Di,
    N). Per step ``h = exp(dt*A) * h + (dt*x) * B_t`` and ``y_t = sum_n h *
    C_t``, all in float32. Returns ``y`` (B, T, Di) and ``h_T`` (B, Di, N),
    float32. Follows ``repro/kernels/ref.py::fused_selective_scan`` element
    for element; dA and dBx are formed one step at a time, so no (B, T, Di,
    N) tensor is held. float64 inputs stay float64 (for gradient checks).
    """
    dt32, x32 = _up(dt), _up(x)
    A32, Bf, C = _up(A), _up(B_coef), _up(C_coef)
    h = _up(h0)
    y = dt32.new_empty(dt.shape)
    for t in range(dt.shape[1]):
        dA = torch.exp(dt32[:, t, :, None] * A32)
        dBx = (dt32[:, t] * x32[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBx
        y[:, t] = torch.einsum("bdn,bn->bd", h, C[:, t])
    return y, h


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor, *,
             reverse: bool = False):
    """The state recurrence with every state kept, a loop over time.

    dA, dBx: (B, T, Di, N); h0: (B, Di, N). Per step ``h = dA_t * h +
    dBx_t``, all float32; returns ``hs`` (B, T, Di, N) and ``h_T`` (B, Di,
    N). Follows ``repro/kernels/ref.py::ssm_scan``; ``reverse`` walks t from
    T - 1 down to 0 (the adjoint recurrence of the selective scan's
    backward), and ``h_T`` is then the state after t = 0. float64 inputs
    stay float64."""
    dA32, dBx32 = _up(dA), _up(dBx)
    h = _up(h0)
    hs = dA32.new_empty(dA.shape)
    steps = range(dA.shape[1] - 1, -1, -1) if reverse else range(dA.shape[1])
    for t in steps:
        h = dA32[:, t] * h + dBx32[:, t]
        hs[:, t] = h
    return hs, h


def _scan_coeffs(dt, A, B_coef, x):
    """dA = exp(dt * A) and dBx = (dt * x) * B_t, (B, T, Di, N)."""
    return (torch.exp(dt[..., None] * A),
            (dt * x)[..., None] * B_coef[:, :, None, :])


def fused_selective_scan_bwd(dt: torch.Tensor, A: torch.Tensor,
                             B_coef: torch.Tensor, C_coef: torch.Tensor,
                             x: torch.Tensor, h0: torch.Tensor,
                             dy: torch.Tensor, dh_T: torch.Tensor, *,
                             chunk: int | None = None):
    """The gradient of :func:`fused_selective_scan`: (d_dt, d_A, d_B, d_C,
    d_x, d_h0) from the forward's inputs and the gradients dy (B, T, Di)
    and dh_T (B, Di, N) of its outputs.

    With ``a_t = exp(dt_t A)``, ``u_t = dt_t x_t`` and the states h_t
    recomputed by :func:`ssm_scan`, the adjoint is the reversed scan
    ``lambda_t = dy_t C_t + a_{t+1} lambda_{t+1}`` (``lambda_{T-1} =
    dy_{T-1} C_{T-1} + dh_T``), and with ``g_t = lambda_t h_{t-1} a_t``
    (``h_{-1} = h0``): ``d_dt = sum_n (g A + lambda B x)``, ``d_x = dt
    sum_n lambda B``, ``d_A = sum_{b,t} g dt``, ``d_B = sum_d lambda u``,
    ``d_C = sum_d dy h_t`` and ``d_h0 = a_0 lambda_0``.

    ``chunk`` steps at a time (all T by default) the states are recomputed
    from the state entering the chunk, kept by a first sweep, and the
    adjoint is walked back through them, so no (B, T, Di, N) tensor is
    held; every element and every sum is formed the same way whatever the
    chunk (d_A is summed over b, then over t from T - 1 down), so the
    result does not depend on it. Gradients come in their input's type,
    computed in float32 (float64 kept, for gradient checks)."""
    dt32, A32, B32, C32, x32 = (_up(t) for t in (dt, A, B_coef, C_coef, x))
    h0f, dy32, dh32 = _up(h0), _up(dy), _up(dh_T)
    T = dt.shape[1]
    L = T if chunk is None else chunk
    if L < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    starts, h = [], h0f  # the state entering each chunk
    for c0 in range(0, T, L):
        starts.append(h)
        dA, dBx = _scan_coeffs(dt32[:, c0:c0 + L], A32, B32[:, c0:c0 + L],
                               x32[:, c0:c0 + L])
        _, h = ssm_scan(dA, dBx, h)
    d_dt, d_x = torch.empty_like(dt32), torch.empty_like(x32)
    d_B, d_C = torch.empty_like(B32), torch.empty_like(C32)
    d_A = torch.zeros_like(A32)
    lam_next = torch.zeros_like(h0f)  # lambda at the step after the chunk
    a_after = torch.zeros_like(h0f)   # a at the step after the chunk
    for c0, h_in in reversed(list(zip(range(0, T, L), starts))):
        c1 = min(c0 + L, T)
        sl = slice(c0, c1)
        u = dt32[:, sl] * x32[:, sl]
        dA, dBx = _scan_coeffs(dt32[:, sl], A32, B32[:, sl], x32[:, sl])
        hs, _ = ssm_scan(dA, dBx, h_in)
        g = dy32[:, sl, :, None] * C32[:, sl, None, :]
        if c1 == T:
            g[:, -1] += dh32
        a_next = torch.empty_like(dA)
        a_next[:, :-1] = dA[:, 1:]
        a_next[:, -1] = a_after
        lam, _ = ssm_scan(a_next, g, lam_next, reverse=True)
        del g, a_next
        h_prev = torch.cat([h_in[:, None], hs[:, :-1]], dim=1)
        gA = lam * h_prev * dA  # lambda_t h_{t-1} a_t
        del h_prev
        lamB = (lam * B32[:, sl, None, :]).sum(-1)
        d_dt[:, sl] = (gA * A32).sum(-1) + x32[:, sl] * lamB
        d_x[:, sl] = dt32[:, sl] * lamB
        d_B[:, sl] = (lam * u[..., None]).sum(2)
        d_C[:, sl] = (dy32[:, sl, :, None] * hs).sum(2)
        contrib = gA * dt32[:, sl, :, None]
        per_t = contrib[0]
        for b in range(1, contrib.shape[0]):
            per_t = per_t + contrib[b]
        for t in range(c1 - c0 - 1, -1, -1):
            d_A = d_A + per_t[t]
        del contrib, per_t, gA, hs
        lam_next, a_after = lam[:, 0], dA[:, 0]
    d_h0 = a_after * lam_next
    return (d_dt.to(dt.dtype), d_A.to(A.dtype), d_B.to(B_coef.dtype),
            d_C.to(C_coef.dtype), d_x.to(x.dtype), d_h0.to(h0.dtype))


def quantize_int8(x: torch.Tensor, block: int = 256):
    """Per-block symmetric int8 quantization along the last axis: scale =
    max(max|x| / 127, 1e-12) per block of ``block`` elements, q =
    clip(round(x / scale), -127, 127). Returns (q int8 of x's shape,
    float32 scales with last dim n_blocks). Follows
    ``repro/kernels/ref.py::quantize_int8``; ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    shape = x.shape
    n = shape[-1]
    if n % block:
        raise ValueError(f"last dim {n} is not a multiple of {block}")
    xb = x.reshape(shape[:-1] + (n // block, block)).float()
    amax = xb.abs().amax(dim=-1)
    # a true division: on a CUDA tensor, dividing by a Python scalar
    # multiplies by its reciprocal, which rounds differently
    scale = torch.clamp_min(amax / amax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, block: int = 256):
    """``q * scale`` per block of ``block`` along the last axis, float32.
    Follows ``repro/kernels/ref.py::dequantize_int8``."""
    shape = q.shape
    n = shape[-1]
    qb = q.reshape(shape[:-1] + (n // block, block)).float()
    return (qb * scale[..., None]).reshape(shape)


def _flat_index(idx: torch.Tensor, B: int, n: int) -> torch.Tensor:
    """(…) segment ids, shared (1-D) or per cell (B, …), as flat ids into a
    (B * n) buffer: cell b's segments occupy [b*n, (b+1)*n)."""
    idx = idx.to(torch.int64)
    off = torch.arange(B, device=idx.device).view(-1, *([1] * max(
        idx.dim() - 1, 1))) * n
    if idx.dim() == 1:
        idx = idx[None]
    return (idx + off).reshape(-1)


def _segment_sum(vals: torch.Tensor, flat: torch.Tensor, B: int,
                 n: int) -> torch.Tensor:
    out = torch.zeros(B * n, dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, flat, vals.reshape(-1)).view(B, n)


def fabric_step_core(plinks, inject, src_id, host_caps, q, occ, caps_finite,
                     src_sw, dst_sw, dt, qmax_bytes, hol_factor, hol_start,
                     burst_jitter, *, n_src: int, n_sw: int,
                     with_aux: bool = False):
    """The memory-bound core of one simulator step, batched over cells.

    Shapes: ``plinks`` (B, F, H) link ids with pad == sink ==
    ``q.shape[1] - 1``; ``inject``/``host_caps`` (B, F); ``src_id`` (F,)
    or (B, F); ``q``/``occ`` (B, L+1) with ``occ == q / qmax_bytes``;
    ``caps_finite``/``src_sw``/``dst_sw`` (L+1,) or (B, L+1); the five
    scalars (B,). Follows ``repro/kernels/ref.py::fabric_step_core``
    statement for statement, in this order (DESIGN.md §13):

    * NIC limit — ``src_load`` segment-sum over ``src_id``;
    * backpressure — ``hot_q``/``tot_q`` segment sums and the ``sw_sat``
      segment max over ``src_sw``, the stall gathered through ``dst_sw``
      into per-link effective capacities;
    * H-hop staged propagation — per hop a link-load scatter, the FIFO
      over-subscription divide, arrival accumulation (and the served-rate
      observer when ``with_aux``);
    * the queue update, clipped to [0, qmax], sink pinned to 0.

    Segment sums go through ``index_add_`` over the flattened (cell x
    segment) index. Returns ``inject`` (NIC-scaled), ``achieved``,
    ``arrival``, ``q_new``, ``caps_eff`` and ``served_stage_max`` (None
    unless ``with_aux``)."""
    B, F, H = plinks.shape
    L1 = q.shape[1]
    sink = L1 - 1
    valid = plinks < sink
    col = lambda x: x[:, None]  # noqa: E731  (B,) scalar -> (B, 1)
    # ---- NIC limit: a source's flows share its injection link ----
    src_flat = _flat_index(src_id, B, n_src)
    src_load = _segment_sum(inject, src_flat, B, n_src)
    scale = torch.clamp_max(
        host_caps / torch.clamp_min(src_load.view(-1)[src_flat].view(B, F),
                                    1.0), 1.0)
    inject = inject * scale
    # ---- lossless backpressure (credit/PFC head-of-line stall) ----
    sat_l = torch.clamp((occ - col(hol_start)) / (1.0 - col(hol_start)),
                        0.0, 1.0)
    sw_flat = _flat_index(src_sw, B, n_sw)
    hot_q = _segment_sum(q * sat_l, sw_flat, B, n_sw)
    tot_q = _segment_sum(q, sw_flat, B, n_sw)
    share = hot_q / torch.clamp_min(tot_q, 1.0)
    sw_sat = torch.zeros(B * n_sw, dtype=q.dtype, device=q.device) \
        .scatter_reduce_(0, sw_flat, sat_l.reshape(-1), "amax",
                         include_self=True).view(B, n_sw)
    stall = 1.0 - col(hol_factor) * sw_sat * share
    stall[:, 0] = 1.0  # 0 == host endpoint
    caps_eff = caps_finite * stall.view(-1)[
        _flat_index(dst_sw, B, n_sw)].view(B, L1)
    # ---- staged propagation + queues ----
    lk_flat = _flat_index(plinks.reshape(B, F * H), B, L1).view(B, F, H)
    r = inject
    arrival = torch.zeros_like(q)
    served_stage_max = torch.zeros_like(q)
    for h in range(H):
        lk = lk_flat[:, :, h].reshape(-1)
        vh = valid[:, :, h]
        # a padded hop contributes 0, also for a NaN rate: the reference's
        # ``r * valid`` runs as a select under XLA
        load = _segment_sum(torch.where(vh, r, 0.0), lk, B, L1)
        arrival = arrival + load
        over = torch.clamp_min(load / caps_eff, 1.0)
        r = torch.where(vh, r / over.view(-1)[lk].view(B, F), r)
        if with_aux:
            served = _segment_sum(torch.where(vh, r, 0.0), lk, B, L1)
            served_stage_max = torch.maximum(served_stage_max, served)
    q_new = torch.minimum(
        torch.clamp_min(q + (arrival * (1.0 + col(burst_jitter))
                             - caps_eff) * col(dt), 0.0),
        col(qmax_bytes))
    q_new[:, sink] = 0.0
    return {"inject": inject, "achieved": r, "arrival": arrival,
            "q_new": q_new, "caps_eff": caps_eff,
            "served_stage_max": served_stage_max if with_aux else None}
