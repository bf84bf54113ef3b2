"""Device dispatch for the kernels.

A CPU tensor goes to the plain PyTorch version (``ref``). A CUDA tensor
goes to the hand-written kernel, or to the plain version when the caller
asks for ``core="plain"`` (only to compare the two on the card); the
kernel raises on what it does not take, with no fallback.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fabric_step as _fs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_reduce as _fr
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ss

CORES = ("kernel", "plain")
pack_scalars = _fs.pack_scalars


def _use_plain(device: torch.device, core: str, name: str) -> bool:
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, got {core!r}")
    if device.type == "cpu" or core == "plain":
        return True
    if device.type != "cuda":
        raise ValueError(f"no {name} for device {device}")
    return False


def fabric_step_core(*args, core: str = "kernel", scalars=None, **kw):
    """Fused fabric-simulator step core; same signature and return dict
    as :func:`repro_torch.kernels.ref.fabric_step_core`. ``scalars`` is
    the kernel's packed (B, 5) block of the five scalar arguments
    (:func:`pack_scalars`); the plain version reads the arguments."""
    if _use_plain(args[1].device, core, "fabric_step_core"):  # inject
        return ref.fabric_step_core(*args, **kw)
    return _fs.fabric_step_core(*args, scalars=scalars, **kw)


def fused_accumulate(acc, x, scale: float = 1.0, core: str = "kernel"):
    """Ring-AllReduce receive-accumulate ``acc + scale * x`` in float32,
    rounded to ``acc.dtype`` (paper Fig. 1)."""
    if _use_plain(acc.device, core, "fused_accumulate"):
        return ref.fused_accumulate(acc, x, scale)
    return _fr.fused_accumulate(acc, x, scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    core: str = "kernel"):
    """Blockwise GQA attention, q (B, Sq, H, D), k/v (B, Skv, KH, D), in
    ``q.dtype``; ``window`` > 0 is the sliding-window mask of the models'
    prefill (kernel 7)."""
    if _use_plain(q.device, core, "flash_attention"):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def fused_selective_scan(dt, A, B_coef, C_coef, x, h0, core: str = "kernel"):
    """Mamba selective scan with the state on chip: (y (B, T, Di), h_T (B,
    Di, N)), both float32 (kernel 6)."""
    if _use_plain(dt.device, core, "fused_selective_scan"):
        return ref.fused_selective_scan(dt, A, B_coef, C_coef, x, h0)
    return _ss.fused_selective_scan(dt, A, B_coef, C_coef, x, h0)
