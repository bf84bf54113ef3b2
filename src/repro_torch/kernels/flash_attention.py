"""Wrapper for the hand-written CUDA flash-attention kernel (kernel 7).

``csrc/flash_attention.cu`` is compiled with nvcc for ``sm_90a``
(``_build``, into ``build/`` at first use) and called through ``ctypes``
on PyTorch's current stream. It replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and adds the models'
sliding-window mask; ``kernels/ref.py::flash_attention`` is its plain
version.

The wrapper only takes CUDA tensors and never falls back: a device, type,
head size, shape or layout the kernel does not take raises. ``launches``
counts the kernel launches since import (or since a caller reset it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "flash_attention.cu"
# fused multiply-adds on: the dot products gain accuracy from them
FLAGS = tuple(f for f in _build.NVCC_FLAGS if f != "--fmad=false")
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 128)  # the kernel's template instances

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of q (B, Sq, H, D) over k, v (B, Skv, KH, D), all CUDA
    tensors of one type (float32 or bfloat16), contiguous, on one device;
    query head h reads KV head h // (H // KH); ``window`` > 0 masks keys at
    or before ``q_pos - window``. Output in ``q.dtype``."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Skv, H, KH, D, int(causal), int(window),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    launches += 1
    return out
