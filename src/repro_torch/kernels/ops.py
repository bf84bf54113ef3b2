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

Kernels 7 and 6 and their backwards take meta tensors too (the dry run,
``launch/dryrun.py``; the plain attention would hold the S x S scores the
kernel never holds, and the plain scan loops over time): their meta
branches return outputs of the kernel's shapes and types, allocate what
the wrapper allocates on the card, and append each call's kind,
dimensions and bytes moved to the list :func:`record_meta` installs. No
CPU or CUDA call reaches them; the other kernels raise on meta, as on
any device but the CPU and CUDA.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.kernels import fabric_step as _fs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_reduce as _fr
from repro_torch.kernels import quant as _q
from repro_torch.kernels import ref
from repro_torch.kernels import ssm_scan as _ss

CORES = ("kernel", "plain")
pack_scalars = _fs.pack_scalars


_meta_calls = None  # the list record_meta installs


@contextlib.contextmanager
def record_meta(calls: list):
    """Append the meta branches' calls to ``calls`` inside the block:
    ``{"kernel", "dims", "bytes"}``, dims (B, Sq, Skv, H, KH, D) for
    ``flash_attention`` and ``flash_attention_bwd``, (B, T, Di, N) for
    ``fused_selective_scan`` and ``fused_selective_scan_bwd``."""
    global _meta_calls
    prev, _meta_calls = _meta_calls, calls
    try:
        yield calls
    finally:
        _meta_calls = prev


def _record(kernel: str, dims: tuple, *tensors):
    if _meta_calls is not None:
        _meta_calls.append({"kernel": kernel, "dims": tuple(dims),
                            "bytes": sum(t.numel() * t.element_size()
                                         for t in tensors)})


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


def _attention_dims(q, k):
    B, Sq, H, D = q.shape
    return B, Sq, k.shape[1], H, k.shape[2], D


def _meta_attention(q, k, v, return_lse):
    """Kernel 7 on meta: its output (and row log-sum-exp)."""
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1],
                      dtype=torch.float32, device=q.device) \
        if return_lse else None
    _record("flash_attention", _attention_dims(q, k), q, k, v, out,
            *([lse] if return_lse else []))
    return (out, lse) if return_lse else out


def _meta_attention_bwd(q, k, v, o, lse, do):
    """Kernel 7's backward on meta: dq, dk, dv and the float32 workspace
    the wrapper allocates (delta; in bfloat16 the dK/dV head chunks)."""
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    B, Sq, Skv, H, KH, D = _attention_dims(q, k)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    n_split = math.ceil((H // KH) / _fa.BWD_HEADS_A_BLOCK)
    part = torch.empty(2 * n_split, B, Skv, KH, D, dtype=torch.float32,
                       device=q.device) \
        if q.dtype == torch.bfloat16 and n_split > 1 else None
    _record("flash_attention_bwd", (B, Sq, Skv, H, KH, D), q, k, v, o, lse,
            do, *grads)
    del delta, part
    return grads


def _attention(q, k, v, causal, window, core, return_lse=False):
    if q.device.type == "meta":
        return _meta_attention(q, k, v, return_lse)
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
        if q.device.type == "meta":
            grads = _meta_attention_bwd(q, k, v, o, lse, do)
        elif _use_plain(q.device, core, "flash_attention_bwd"):
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
    if dt.device.type == "meta":  # kernel 6's outputs, float32
        B, T, Di = x.shape
        N = A.shape[1]
        y = torch.empty(B, T, Di, dtype=torch.float32, device=dt.device)
        h_T = torch.empty(B, Di, N, dtype=torch.float32, device=dt.device)
        _record("fused_selective_scan", (B, T, Di, N), dt, A, B_coef,
                C_coef, x, h0, y, h_T)
        return y, h_T
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
        if args[0].device.type == "meta":
            grads = tuple(torch.empty_like(t) for t in args[:6])
            B, T, Di = args[4].shape
            _record("fused_selective_scan_bwd", (B, T, Di, args[1].shape[1]),
                    *args, *grads)
            return (*grads, None)
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
