"""Wrapper for the hand-written CUDA fused selective scan (kernel 6).

``csrc/ssm_scan.cu`` is compiled with nvcc for ``sm_90a`` (``_build``,
into ``build/`` at first use) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernel
``repro/kernels/ssm_scan.py::fused_selective_scan``;
``kernels/ref.py::fused_selective_scan`` is its plain version.

The wrapper only takes CUDA tensors and never falls back: a device, type,
state size, shape or layout the kernel does not take raises. ``launches``
counts the kernel launches since import (or since a caller reset it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "ssm_scan.cu"
SCAN_SOURCE = _build.CSRC / "state_scan.cu"
FLAGS = _build.NVCC_FLAGS
STATES = (8, 16)  # the kernel's template instances of N

launches = 0       # fused_selective_scan (kernel 6)
scan_launches = 0  # ssm_scan (kernel 5)
_lib = None
_scan_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.fused_selective_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _load_scan():
    global _scan_lib
    if _scan_lib is None:
        lib = _build.load(SCAN_SOURCE, FLAGS)
        fn = lib.ssm_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.state_scan_error_string.argtypes = [ctypes.c_int]
        lib.state_scan_error_string.restype = ctypes.c_char_p
        _scan_lib = lib
    return _scan_lib


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor, *,
             reverse: bool = False):
    """(hs (B, T, Di, N), h_T (B, Di, N)), float32, of ``h = dA_t * h +
    dBx_t`` from h0 over dA, dBx (B, T, Di, N) and h0 (B, Di, N): float32
    CUDA tensors, contiguous, on one device; ``reverse`` walks t from T - 1
    down to 0."""
    global scan_launches
    for name, t in (("dA", dA), ("dBx", dBx), ("h0", h0)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dA.device:
            raise ValueError(f"dA on {dA.device}, {name} on {t.device}")
    if dA.dim() != 4 or dBx.shape != dA.shape:
        raise ValueError(f"dA {tuple(dA.shape)} and dBx {tuple(dBx.shape)} "
                         "must be one (B, T, Di, N) shape")
    B, T, Di, N = dA.shape
    if tuple(h0.shape) != (B, Di, N):
        raise ValueError(f"h0 is {tuple(h0.shape)}, expected {(B, Di, N)}")
    hs = torch.empty_like(dA)
    if B * Di * N == 0:
        return hs, h0.clone()
    h_T = torch.empty_like(h0)
    lib = _load_scan()
    with torch.cuda.device(dA.device):
        stream = torch.cuda.current_stream(dA.device).cuda_stream
        rc = lib.ssm_scan_launch(dA.data_ptr(), dBx.data_ptr(), h0.data_ptr(),
                                 hs.data_ptr(), h_T.data_ptr(), B, T, Di, N,
                                 int(reverse), stream)
    if rc != 0:
        raise RuntimeError("ssm_scan launch failed: "
                           + lib.state_scan_error_string(rc).decode())
    scan_launches += 1
    return hs, h_T


def fused_selective_scan(dt: torch.Tensor, A: torch.Tensor,
                         B_coef: torch.Tensor, C_coef: torch.Tensor,
                         x: torch.Tensor, h0: torch.Tensor):
    """(y (B, T, Di), h_T (B, Di, N)), float32, of the selective scan over
    dt (B, T, Di), A (Di, N), B_coef / C_coef (B, T, N), x (B, T, Di) and
    h0 (B, Di, N): CUDA tensors, contiguous, on one device; x float32 or
    bfloat16, everything else float32."""
    global launches
    args = (("dt", dt), ("A", A), ("B_coef", B_coef), ("C_coef", C_coef),
            ("x", x), ("h0", h0))
    for name, t in args:
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        want = (torch.float32, torch.bfloat16) if name == "x" \
            else (torch.float32,)
        if t.dtype not in want:
            raise TypeError(f"{name} must be {' or '.join(map(str, want))}"
                            f", got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dt.device:
            raise ValueError(f"dt on {dt.device}, {name} on {t.device}")
    if dt.dim() != 3:
        raise ValueError(f"dt must be (B, T, Di), got {tuple(dt.shape)}")
    B, T, Di = dt.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    shapes = {"A": (Di, N), "B_coef": (B, T, N), "C_coef": (B, T, N),
              "x": (B, T, Di), "h0": (B, Di, N)}
    for name, t in args[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if N not in STATES:
        raise ValueError(f"state size {N} not in {STATES}")
    y = torch.empty((B, T, Di), dtype=torch.float32, device=dt.device)
    h_T = torch.empty((B, Di, N), dtype=torch.float32, device=dt.device)
    if B == 0 or Di == 0:
        return y, h_T
    lib = _load()
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        rc = lib.fused_selective_scan_launch(
            dt.data_ptr(), A.data_ptr(), B_coef.data_ptr(),
            C_coef.data_ptr(), x.data_ptr(), h0.data_ptr(), y.data_ptr(),
            h_T.data_ptr(), B, T, Di, N, int(x.dtype == torch.bfloat16),
            stream)
    if rc != 0:
        raise RuntimeError("fused_selective_scan launch failed: "
                           + lib.ssm_scan_error_string(rc).decode())
    launches += 1
    return y, h_T
