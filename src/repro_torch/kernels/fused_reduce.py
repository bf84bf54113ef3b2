"""Wrapper for the hand-written CUDA fused-accumulate kernel.

``csrc/fused_reduce.cu`` is compiled with nvcc for ``sm_90a`` (``_build``,
into ``build/`` at first use) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernel
``repro/kernels/fused_reduce.py::fused_accumulate``, the ring-AllReduce
receive-accumulate of paper Fig. 1; ``kernels/ref.py::fused_accumulate``
is its plain version.

The wrapper only takes CUDA tensors and never falls back: a device, type,
shape or layout the kernel does not take raises. ``launches`` counts the
kernel launches since import (or since a caller reset it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "fused_reduce.cu"
FLAGS = _build.NVCC_FLAGS
DTYPES = (torch.float32, torch.bfloat16)

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.fused_accumulate_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fused_reduce_error_string.argtypes = [ctypes.c_int]
        lib.fused_reduce_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def fused_accumulate(acc: torch.Tensor, x: torch.Tensor,
                     scale: float = 1.0) -> torch.Tensor:
    """``acc + scale * x`` accumulated in float32 and rounded to
    ``acc.dtype``, into a new tensor; ``acc`` and ``x`` are (R, C) CUDA
    tensors of float32 or bfloat16 each, contiguous, on one device."""
    global launches
    for name, t in (("acc", acc), ("x", x)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be (R, C), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if acc.shape != x.shape:
        raise ValueError(f"acc {tuple(acc.shape)} and x {tuple(x.shape)} "
                         "differ in shape")
    if acc.device != x.device:
        raise ValueError(f"acc on {acc.device}, x on {x.device}")
    out = torch.empty_like(acc)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream(acc.device).cuda_stream
        rc = lib.fused_accumulate_launch(
            acc.data_ptr(), x.data_ptr(), out.data_ptr(), acc.numel(),
            float(scale), int(acc.dtype == torch.bfloat16),
            int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("fused_accumulate launch failed: "
                           + lib.fused_reduce_error_string(rc).decode())
    launches += 1
    return out
