"""Device dispatch for the kernels, and the gradients of the two the
training path differentiates.

A CPU tensor goes to the plain PyTorch version (``ref``). A CUDA tensor
goes to the hand-written kernel, or to the plain version when the caller
asks for ``core="plain"`` (only to compare the two on the card); the
kernel raises on what it does not take, with no fallback. The same holds
for each gradient: ``flash_attention`` and ``fused_selective_scan`` become
``torch.autograd.Function``s (:class:`FlashAttentionFn`,
:class:`SelectiveScanFn`) when an input requires a gradient, and their
backward runs kernels on the card (the attention backward; kernel 5 twice)
and plain versions on the CPU or under ``core="plain"``.
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
    """Kernel 6 in the forward, which keeps only its inputs. The backward
    recomputes the states and runs the adjoint recurrence, each through
    kernel 5:

    1. dA = exp(dt * A) and dBx = (dt * x) * B_t, with autograd;
    2. hs = scan(dA, dBx, h0);
    3. g_t = dy_t (x) C_t, plus dh_T at the last step;
    4. lambda_t = g_t + dA_{t+1} * lambda_{t+1}: the reversed scan of g
       with dA shifted one step earlier (lambda_{T-1} = g_{T-1});
    5. d dBx = lambda, d dA_t = lambda_t * h_{t-1} (h_{-1} = h0),
       d h0 = dA_0 * lambda_0, d C_t = sum_d dy_{t,d} h_{t,d,:};
    6. autograd carries d dA and d dBx into dt, A, B and x.

    Steps 1, 3, 5 and 6 are the elementwise work the JAX package runs
    outside any kernel (``repro/models/ssm.py::_ssm_coeffs`` and XLA's
    transpose of its scan)."""

    @staticmethod
    def forward(ctx, dt, A, B_coef, C_coef, x, h0, core):
        y, h_T = _selective_scan(dt, A, B_coef, C_coef, x, h0, core)
        ctx.save_for_backward(dt, A, B_coef, C_coef, x, h0)
        ctx.core = core
        return y, h_T

    @staticmethod
    def backward(ctx, dy, dh_T):
        dt, A, B_coef, C_coef, x, h0 = ctx.saved_tensors
        core = ctx.core
        f = dt.dtype  # float32 (float64 in gradient checks)
        with torch.enable_grad():
            dt_, A_, B_, x_ = (t.detach().requires_grad_()
                               for t in (dt, A, B_coef, x))
            dA = torch.exp(dt_[..., None] * A_)
            dBx = (dt_ * x_.to(f))[..., None] * B_[:, :, None, :]
        h0f = h0.to(f)
        hs, _ = ssm_scan(dA.detach(), dBx.detach(), h0f, core=core)
        g = dy.to(f)[..., None] * C_coef.to(f)[:, :, None, :]
        g[:, -1] += dh_T.to(f)
        a_next = torch.zeros_like(hs)
        a_next[:, :-1] = dA.detach()[:, 1:]
        lam, _ = ssm_scan(a_next, g, torch.zeros_like(h0f), reverse=True,
                          core=core)
        del g, a_next
        d_dA = torch.empty_like(lam)
        d_dA[:, 1:] = lam[:, 1:] * hs[:, :-1]
        d_dA[:, 0] = lam[:, 0] * h0f
        dC = torch.einsum("btd,btdn->btn", dy.to(f), hs)
        dh0 = dA.detach()[:, 0] * lam[:, 0]
        del hs
        torch.autograd.backward((dA, dBx), (d_dA, lam))
        return (dt_.grad, A_.grad, B_.grad, dC.to(C_coef.dtype), x_.grad,
                dh0.to(h0.dtype), None)


def fused_selective_scan(dt, A, B_coef, C_coef, x, h0, core: str = "kernel"):
    """Mamba selective scan with the state on chip: (y (B, T, Di), h_T (B,
    Di, N)), both float32 (kernel 6). Differentiable
    (:class:`SelectiveScanFn`) when an input requires a gradient."""
    if _wants_grad(dt, A, B_coef, C_coef, x, h0):
        return SelectiveScanFn.apply(dt, A, B_coef, C_coef, x, h0, core)
    return _selective_scan(dt, A, B_coef, C_coef, x, h0, core)
