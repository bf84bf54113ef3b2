"""Wrappers for the hand-written CUDA int8 quantize and dequantize
(kernels 3 and 4).

``csrc/quant.cu`` is compiled with nvcc for ``sm_90a`` (``_build``, into
``build/`` at first use) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernels
``repro/kernels/quant.py::quantize_int8`` and ``dequantize_int8``;
``kernels/ref.py::quantize_int8`` / ``dequantize_int8`` are their plain
versions, with which the kernels are bit-equal.

The wrappers only take CUDA tensors and never fall back: a device, type,
block size, shape or layout the kernels do not take raises.
``launches`` and ``dq_launches`` count the launches since import (or since
a caller reset them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "quant.cu"
FLAGS = _build.NVCC_FLAGS
BLOCK = 256  # the kernels' quantization block

launches = 0     # quantize_int8 (kernel 3)
dq_launches = 0  # dequantize_int8 (kernel 4)
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        for fn in (lib.quantize_int8_launch, lib.dequantize_int8_launch):
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.quant_error_string.argtypes = [ctypes.c_int]
        lib.quant_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name, t, dtype, align):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def _blocks(shape, block) -> int:
    if block != BLOCK:
        raise ValueError(f"block {block}: the kernels take {BLOCK}")
    if len(shape) < 1 or shape[-1] % BLOCK:
        raise ValueError(f"last dim of {tuple(shape)} is not a multiple of "
                         f"{BLOCK}")
    n = 1
    for d in shape:
        n *= d
    return n // BLOCK


def _run(fn, args, device):
    lib = _load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: "
                           + lib.quant_error_string(rc).decode())


def quantize_int8(x: torch.Tensor, block: int = BLOCK):
    """(q int8 of x's shape, float32 scales (..., C / 256)) of float32 x
    (..., C), C a multiple of 256, a contiguous CUDA tensor."""
    global launches
    _check("x", x, torch.float32, 16)
    n_blocks = _blocks(x.shape, block)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (x.shape[-1] // BLOCK,),
                         dtype=torch.float32, device=x.device)
    if n_blocks:
        _run(_load().quantize_int8_launch,
             (x.data_ptr(), q.data_ptr(), scales.data_ptr(), n_blocks),
             x.device)
        launches += 1
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    block: int = BLOCK) -> torch.Tensor:
    """float32 ``q * scale`` per block of 256 of int8 q (..., C) and
    float32 scales (..., C / 256), contiguous CUDA tensors on one device."""
    global dq_launches
    _check("q", q, torch.int8, 8)
    _check("scales", scales, torch.float32, 4)
    if scales.device != q.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    n_blocks = _blocks(q.shape, block)
    if tuple(scales.shape) != tuple(q.shape[:-1]) + (q.shape[-1] // BLOCK,):
        raise ValueError(f"scales {tuple(scales.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    if n_blocks:
        _run(_load().dequantize_int8_launch,
             (q.data_ptr(), scales.data_ptr(), out.data_ptr(), n_blocks),
             q.device)
        dq_launches += 1
    return out
