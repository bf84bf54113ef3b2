"""Int8 error-feedback gradient compression, as
``repro/optim/compression.py``.

Each gradient leaf, plus its error-feedback residual, is flattened, padded
to a multiple of 256, quantized per 256-block to int8 with a float32 scale
(kernel 3 on the card, ``kernels.ops.quantize_int8``) and dequantized back
(kernel 4) to form the new residual, so the series of decompressed
gradients telescopes to the true gradient sum (Karimireddy et al. 2019,
"EF-SGD"). Trees are dicts of tensors keyed by leaf name; a payload leaf is
``(q int8, scales float32, n)``. ``core="plain"`` runs the plain versions
on the card, to compare.

``compressed_psum_mean`` is the collective that moves the payload over a
``torch.distributed`` group: each rank quantizes its value (kernel 3),
all-gathers the int8 payload and its scales (``core.collectives``),
dequantizes every rank's part (kernel 4) and sums the parts in rank order.
Wire bytes a rank: (n-1)/n * V * (1 + 4/block) against 2 * (n-1)/n * V * 4
for a ring all-reduce of float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import collectives
from repro_torch.kernels import ops

BLOCK = 256


def _pad_to_block(v: torch.Tensor, block: int):
    n = v.shape[0]
    pad = (-n) % block
    if pad:
        v = F.pad(v, (0, pad))
    return v, n


def compress_leaf(g: torch.Tensor, ef: torch.Tensor, block: int = BLOCK,
                  core: str = "kernel"):
    """(g + ef) -> (q int8, scales, new_ef). Shapes: g and ef flat (N,)."""
    v = g.float() + ef
    vp, n = _pad_to_block(v, block)
    q, s = ops.quantize_int8(vp.reshape(1, -1), block, core=core)
    back = ops.dequantize_int8(q, s, block, core=core).reshape(-1)[:n]
    return q.reshape(-1), s.reshape(-1), v - back


def decompress_leaf(q: torch.Tensor, s: torch.Tensor, n: int,
                    block: int = BLOCK, core: str = "kernel") -> torch.Tensor:
    out = ops.dequantize_int8(q.reshape(1, -1), s.reshape(1, -1), block,
                              core=core)
    return out.reshape(-1)[:n]


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros(p.numel(), dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def ef_compress(grads: dict, ef: dict, block: int = BLOCK,
                core: str = "kernel"):
    """Tree-wise error-feedback compression. Returns (payload {name: (q,
    scales, n)}, new_ef {name: flat residual})."""
    payload, new_ef = {}, {}
    for k, g in grads.items():
        q, s, e = compress_leaf(g.reshape(-1), ef[k], block, core)
        payload[k] = (q, s, g.numel())
        new_ef[k] = e
    return payload, new_ef


def ef_decompress(payload: dict, like: dict, block: int = BLOCK,
                  core: str = "kernel") -> dict:
    return {k: decompress_leaf(q, s, like[k].numel(), block,
                               core).reshape(like[k].shape)
            for k, (q, s, _) in payload.items()}


def compressed_psum_mean(x: torch.Tensor, group=None, block: int = BLOCK,
                         core: str = "kernel") -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` moving int8 on the wire,
    as the reference's ``compressed_psum_mean``: not exact (callers pair it
    with error feedback across steps); every rank gets the same bits."""
    v = x.reshape(-1).float()
    vp, n_elem = _pad_to_block(v, block)
    q, s = ops.quantize_int8(vp.reshape(1, -1), block, core=core)
    q_all = collectives.all_gather(q.reshape(-1), group)   # (n, Np) int8
    s_all = collectives.all_gather(s.reshape(-1), group)   # (n, Np/block)
    back = ops.dequantize_int8(q_all, s_all, block, core=core)
    total = back[0]
    for i in range(1, back.shape[0]):  # rank order
        total = total + back[i]
    n = torch.tensor(float(back.shape[0]), device=total.device)
    return (total[:n_elem] / n).reshape(x.shape).to(x.dtype)


def wire_bytes(n_elems: int, dtype_bytes: int = 4, n: int = 2,
               block: int = BLOCK) -> dict:
    """Analytic wire bytes: a ring all-reduce of ``dtype_bytes`` words
    against an all-gather of int8 with one float32 scale per block."""
    frac = (n - 1) / n
    raw_ar = 2 * frac * n_elems * dtype_bytes      # ring all-reduce
    comp_ag = frac * n_elems * (1 + 4.0 / block)   # int8 all-gather
    return {"uncompressed": raw_ar, "compressed": comp_ag,
            "ratio": raw_ar / comp_ag}
