"""Device dispatch for the kernels, and the gradients of the two the
training path differentiates.

A CPU tensor goes to the plain PyTorch version (``ref``). A CUDA tensor
goes to the hand-written kernel, or to the plain version when the caller
asks for ``core="plain"`` (only to compare the two on the card); the
kernel raises on what it does not take, with no fallback. The same holds
for each gradient: ``flash_attention`` and ``fused_selective_scan`` become
``torch.autograd.Function``s (:class:`FlashAttentionFn`,
:class:`SelectiveScanFn`) when an input requires a gradient, and their
backward runs kernels on the card (the attention backward; the selective
scan's fused backward) and plain versions on the CPU or under
``core="plain"``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fabric_step as _fs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_reduce as _fr
from repro_torch.kernels import quant as _q
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
    (:func:`pack_scalars`); the plain version reads the arguments.

    Kernel 1 has no gradient: its outputs carry no ``grad_fn``, so on a
    CUDA input that requires a gradient under ``core="kernel"`` it raises
    instead of letting autograd return a partial gradient without a word.
    A caller that differentiates the step passes ``core="plain"``."""
    if core == "kernel" and args[1].device.type != "cpu" and _wants_grad(
            *(a for a in (*args, *kw.values())
              if isinstance(a, torch.Tensor))):
        raise RuntimeError(
            "fabric_step_core: kernel 1 has no gradient and an input "
            "requires one; pass core='plain' to differentiate the step")
    if _use_plain(args[1].device, core, "fabric_step_core"):  # inject
        return ref.fabric_step_core(*args, **kw)
    return _fs.fabric_step_core(*args, scalars=scalars, **kw)


def fused_accumulate(acc, x, scale: float = 1.0, core: str = "kernel"):
    """Ring-AllReduce receive-accumulate ``acc + scale * x`` in float32,
    rounded to ``acc.dtype`` (paper Fig. 1)."""
    if _use_plain(acc.device, core, "fused_accumulate"):
        return ref.fused_accumulate(acc, x, scale)
    return _fr.fused_accumulate(acc, x, scale)


def quantize_int8(x, block: int = 256, core: str = "kernel"):
    """Per-256-block symmetric int8 quantization of float32 x (..., C):
    (q int8, float32 scales (..., C / 256)) (kernel 3)."""
    if _use_plain(x.device, core, "quantize_int8"):
        return ref.quantize_int8(x, block)
    return _q.quantize_int8(x, block)


def dequantize_int8(q, scale, block: int = 256, core: str = "kernel"):
    """``q * scale`` per block, float32 (kernel 4)."""
    if _use_plain(q.device, core, "dequantize_int8"):
        return ref.dequantize_int8(q, scale, block)
    return _q.dequantize_int8(q, scale, block)


def ssm_scan(dA, dBx, h0, *, reverse: bool = False, core: str = "kernel"):
    """The state recurrence with every state kept: (hs (B, T, Di, N), h_T
    (B, Di, N)) float32; ``reverse`` walks time backwards (kernel 5)."""
    if _use_plain(dA.device, core, "ssm_scan"):
        return ref.ssm_scan(dA, dBx, h0, reverse=reverse)
    return _ss.ssm_scan(dA, dBx, h0, reverse=reverse)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _attention(q, k, v, causal, window, core, return_lse=False):
    if _use_plain(q.device, core, "flash_attention"):
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=return_lse)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               return_lse=return_lse)


class FlashAttentionFn(torch.autograd.Function):
    """Kernel 7 with its row log-sum-exp in the forward; the backward
    kernel (``csrc/flash_attention_bwd.cu``) in the backward, which
    recomputes P from q, k and the log-sum-exp. Plain versions on the CPU
    or under ``core="plain"``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, core):
        o, lse = _attention(q, k, v, causal, window, core, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, core)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, core = ctx.args
        do = do.contiguous()
        if _use_plain(q.device, core, "flash_attention_bwd"):
            grads = ref.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        else:
            grads = _fa.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, window=window)
        return (*grads, None, None, None)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    core: str = "kernel"):
    """Blockwise GQA attention, q (B, Sq, H, D), k/v (B, Skv, KH, D), in
    ``q.dtype``; ``window`` > 0 is the sliding-window mask of the models'
    prefill (kernel 7). Differentiable (:class:`FlashAttentionFn`) when an
    input requires a gradient."""
    if _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, core)
    return _attention(q, k, v, causal, window, core)


def _selective_scan(dt, A, B_coef, C_coef, x, h0, core):
    if _use_plain(dt.device, core, "fused_selective_scan"):
        return ref.fused_selective_scan(dt, A, B_coef, C_coef, x, h0)
    return _ss.fused_selective_scan(dt, A, B_coef, C_coef, x, h0)


class SelectiveScanFn(torch.autograd.Function):
    """Kernel 6 in the forward, which keeps only its inputs; the fused
    backward (``csrc/ssm_scan_bwd.cu``) in the backward, which recomputes
    the states on chip from checkpoints and walks the adjoint recurrence
    back through them (``ref.fused_selective_scan_bwd`` states the math).
    Plain versions on the CPU or under ``core="plain"``. The JAX package
    differentiates its XLA associative scan instead
    (``repro/models/ssm.py``)."""

    @staticmethod
    def forward(ctx, dt, A, B_coef, C_coef, x, h0, core):
        y, h_T = _selective_scan(dt, A, B_coef, C_coef, x, h0, core)
        ctx.save_for_backward(dt, A, B_coef, C_coef, x, h0)
        ctx.core = core
        return y, h_T

    @staticmethod
    def backward(ctx, dy, dh_T):
        args = (*ctx.saved_tensors, dy.contiguous(), dh_T.contiguous())
        if _use_plain(args[0].device, ctx.core, "fused_selective_scan_bwd"):
            grads = ref.fused_selective_scan_bwd(*args)
        else:
            grads = _ss.fused_selective_scan_bwd(*args)
        return (*grads, None)


def fused_selective_scan(dt, A, B_coef, C_coef, x, h0, core: str = "kernel"):
    """Mamba selective scan with the state on chip: (y (B, T, Di), h_T (B,
    Di, N)), both float32 (kernel 6). Differentiable
    (:class:`SelectiveScanFn`) when an input requires a gradient."""
    if _wants_grad(dt, A, B_coef, C_coef, x, h0):
        return SelectiveScanFn.apply(dt, A, B_coef, C_coef, x, h0, core)
    return _selective_scan(dt, A, B_coef, C_coef, x, h0, core)
