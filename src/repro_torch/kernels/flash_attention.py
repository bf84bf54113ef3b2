"""Wrappers for the hand-written CUDA flash attention (kernel 7) and its
backward.

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu`` are
compiled with nvcc for ``sm_90a`` (``_build``, into ``build/`` at first
use) and called through ``ctypes`` on PyTorch's current stream. The
forward replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and adds the models'
sliding-window mask and an optional row log-sum-exp; the backward has no
TPU counterpart (XLA differentiates the JAX package's attention).
``kernels/ref.py::flash_attention`` and ``flash_attention_bwd`` are their
plain versions.

The wrappers only take CUDA tensors and never fall back: a device, type,
head size, shape or layout a kernel does not take raises. ``launches``
counts the forward launches and ``bwd_launches`` the backward ones (one a
call, though a call runs two passes) since import (or since a caller
reset them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
# fused multiply-adds on: the dot products gain accuracy from them
FLAGS = tuple(f for f in _build.NVCC_FLAGS if f != "--fmad=false")
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 128)  # the kernel's template instances

launches = 0
bwd_launches = 0
_lib = None
_bwd_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE, FLAGS)
        fn = lib.flash_attention_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _check_qkv(q, k, v, window, extra=()):
    """Device, type, layout and shape checks shared by both directions;
    returns (B, Sq, Skv, H, KH, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} must share q's type, float32 or "
                            f"bfloat16; got {q.dtype} and {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.device != q.device:
            raise ValueError(f"q on {q.device}, {name} on {t.device}")
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if KH == 0 or H % KH:
        raise ValueError(f"{H} query heads over {KH} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head size {D} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    return B, Sq, Skv, H, KH, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_lse: bool = False):
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, KH, D), all CUDA
    tensors of one type (float32 or bfloat16), contiguous, on one device;
    query head h reads KV head h // (H // KH); ``window`` > 0 masks keys at
    or before ``q_pos - window``. Output in ``q.dtype``; with ``return_lse``
    also each row's log-sum-exp of its scaled scores, (B, H, Sq) float32
    (-inf for a row with no live key)."""
    global launches
    B, Sq, Skv, H, KH, D = _check_qkv(q, k, v, window)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if out.numel():
        lib = _load()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if return_lse else None, B, Sq, Skv, H, KH, D,
                int(causal), int(window), int(q.dtype == torch.bfloat16),
                stream)
        if rc != 0:
            raise RuntimeError(
                "flash_attention launch failed: "
                + lib.flash_attention_error_string(rc).decode())
        launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``o``, its
    row log-sum-exp ``lse`` (B, H, Sq) float32 and the output gradient
    ``do`` (all CUDA, contiguous, q's type but lse). delta = rowsum(dO * O)
    is formed here in float32; the kernel's two passes run on it."""
    global bwd_launches
    B, Sq, Skv, H, KH, D = _check_qkv(q, k, v, window,
                                      (("o", o), ("do", do)))
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} / do {tuple(do.shape)} must "
                         f"be q's shape {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"lse must be contiguous float32 {(B, H, Sq)} on "
                         f"{q.device}, got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel():
        lib = _load_bwd()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = lib.flash_attention_bwd_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, H, KH, D,
                int(causal), int(window), int(q.dtype == torch.bfloat16),
                stream)
        if rc != 0:
            raise RuntimeError(
                "flash_attention_bwd launch failed: "
                + lib.flash_attention_bwd_error_string(rc).decode())
        bwd_launches += 1
    else:
        dq.zero_(), dk.zero_(), dv.zero_()
    return dq, dk, dv
