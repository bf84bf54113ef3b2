"""Mamba-1 selective-SSM block (hymba's SSM heads; falcon-mamba's layers).

Mirrors ``repro/models/ssm.py``. Prefill runs the whole sequence through
kernel 6 (``kernels.ops.fused_selective_scan``) in one launch: the (B, S,
d_inner, N) state never reaches device memory, where the reference's XLA
path materializes it chunk by chunk in an associative scan. Decode is one
O(1) state update in plain PyTorch, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDecl

# the reference's scan chunk: S must be a multiple of min(CHUNK, S)
CHUNK = 256


def ssm_decls(cfg) -> dict:
    d = cfg.d_model
    di, n, r, W = (cfg.resolved_d_inner, cfg.ssm_state,
                   cfg.resolved_dt_rank, cfg.conv_width)
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "in_proj": ParamDecl((d, 2 * di)),
        "conv_w": ParamDecl((di, W), std=0.1),
        "conv_b": ParamDecl((di,), init="zeros"),
        "x_proj": ParamDecl((di, r + 2 * n)),
        "dt_proj": ParamDecl((r, di), std=0.1),
        "dt_bias": ParamDecl((di,), init="zeros"),
        "a_log": ParamDecl((di, n), init="ones"),
        "d_skip": ParamDecl((di,), init="ones"),
        "out_proj": ParamDecl((di, d), std=out_std),
    }


def _ssm_coeffs(x1, p, cfg):
    """From conv'd activations x1 (..., di): dt (..., di), A (di, n) and
    the B, C rows (..., n), all float32."""
    n, r = cfg.ssm_state, cfg.resolved_dt_rank
    proj = (x1 @ p["x_proj"]).float()
    dt_r, B, C = torch.split(proj, [r, n, n], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["a_log"].float())
    return dt, A, B, C


def _causal_conv(x, p, W: int):
    """Depthwise causal conv via W shifted adds. x: (B, S, di)."""
    S = x.shape[1]
    out = x * p["conv_w"][:, W - 1]
    for w in range(W - 1):
        shift = W - 1 - w
        out = out + F.pad(x, (0, 0, shift, 0))[:, :S] * p["conv_w"][:, w]
    return out + p["conv_b"]


def ssm_apply_seq(p, x, cfg, *, core: str = "kernel"):
    """Full-sequence SSM from a zero state. x: (B, S, d_model). Returns
    (y, cache) with cache ``conv`` (B, W-1, di), the last W-1 rows of the
    pre-conv activations, and ``ssm`` (B, di, N) float32."""
    B, S, _ = x.shape
    di, n, W = cfg.resolved_d_inner, cfg.ssm_state, cfg.conv_width
    if S % min(CHUNK, S):  # the reference's contract (ssm.py:81)
        raise ValueError(f"sequence length {S} is not a multiple of "
                         f"{min(CHUNK, S)}")
    x1, z = torch.split(x @ p["in_proj"], [di, di], dim=-1)
    xc = F.silu(_causal_conv(x1, p, W))
    dt, A, Bc, Cc = _ssm_coeffs(xc, p, cfg)
    h0 = torch.zeros(B, di, n, dtype=torch.float32, device=x.device)
    y, h = ops.fused_selective_scan(dt.contiguous(), A.contiguous(),
                                    Bc.contiguous(), Cc.contiguous(),
                                    xc.contiguous(), h0, core=core)
    y = (y + xc.float() * p["d_skip"].float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": x1[:, S - (W - 1):, :], "ssm": h}


def ssm_apply_decode(p, x, cache, cfg):
    """Single-token SSM step. x: (B, d_model); cache {conv (B, W-1, di),
    ssm (B, di, N)}. Returns (y, new cache)."""
    di = cfg.resolved_d_inner
    x1, z = torch.split(x @ p["in_proj"], [di, di], dim=-1)
    win = torch.cat([cache["conv"], x1[:, None]], dim=1)  # (B, W, di)
    xc = F.silu(torch.einsum("bwd,dw->bd", win, p["conv_w"]) + p["conv_b"])
    dt, A, Bc, Cc = _ssm_coeffs(xc, p, cfg)
    dA = torch.exp(dt[..., None] * A)
    dBx = (dt * xc.float())[..., None] * Bc[..., None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cc)
    y = (y + xc.float() * p["d_skip"].float()).to(x.dtype)
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"conv": win[:, 1:], "ssm": h}


def ssm_cache_shape(cfg, batch: int, dtype) -> dict:
    """{name: (shape, dtype)} of one layer's SSM cache."""
    di, n, W = cfg.resolved_d_inner, cfg.ssm_state, cfg.conv_width
    return {"conv": ((batch, W - 1, di), dtype),
            "ssm": ((batch, di, n), torch.float32)}
