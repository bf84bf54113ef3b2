"""Wrappers for the hand-written CUDA selective scans: kernel 6, its fused
backward, and kernel 5, the state scan.

Each source in ``csrc/`` is compiled with nvcc for ``sm_90a`` (``_build``,
into ``build/`` at first use) and called through ``ctypes`` on PyTorch's
current stream. ``csrc/ssm_scan.cu`` replaces the TPU kernel
``repro/kernels/ssm_scan.py::fused_selective_scan`` and
``csrc/state_scan.cu`` its ``ssm_scan``; ``csrc/ssm_scan_bwd.cu`` is the
gradient of the first, which the TPU package leaves to XLA. Their plain
versions are ``kernels/ref.py``'s functions of the same names.

The wrappers only take CUDA tensors and never fall back: a device, type,
state size, shape or layout a kernel does not take raises. ``launches``,
``bwd_launches`` and ``scan_launches`` count each kernel's launches since
import (or since a caller reset them).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "ssm_scan.cu"
BWD_SOURCE = _build.CSRC / "ssm_scan_bwd.cu"
SCAN_SOURCE = _build.CSRC / "state_scan.cu"
FLAGS = _build.NVCC_FLAGS
STATES = (8, 16)  # the kernels' template instances of N

launches = 0       # fused_selective_scan (kernel 6)
bwd_launches = 0   # fused_selective_scan_bwd (its gradient)
scan_launches = 0  # ssm_scan (kernel 5)
_lib = None
_bwd_lib = None
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


def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = _build.load(BWD_SOURCE, FLAGS)
        fn = lib.ssm_scan_bwd_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssm_scan_bwd_chunk.argtypes = []
        lib.ssm_scan_bwd_chunk.restype = ctypes.c_int
        lib.ssm_scan_bwd_channels_per_block.argtypes = [ctypes.c_int]
        lib.ssm_scan_bwd_channels_per_block.restype = ctypes.c_int
        lib.ssm_scan_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


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


def _check_scan_args(args):
    """(B, T, Di, N) of the selective scan's named operands, after checking
    device, type, layout and shapes: dt (B, T, Di), A (Di, N), B_coef and
    C_coef (B, T, N), x (B, T, Di), h0 (B, Di, N), and for the backward dy
    (B, T, Di) and dh_T (B, Di, N); x float32 or bfloat16, everything else
    float32, all contiguous CUDA tensors on one device."""
    dt = args[0][1]
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
    A = args[1][1]
    N = A.shape[-1] if A.dim() == 2 else -1
    shapes = {"A": (Di, N), "B_coef": (B, T, N), "C_coef": (B, T, N),
              "x": (B, T, Di), "h0": (B, Di, N), "dy": (B, T, Di),
              "dh_T": (B, Di, N)}
    for name, t in args[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if N not in STATES:
        raise ValueError(f"state size {N} not in {STATES}")
    return B, T, Di, N


def fused_selective_scan(dt: torch.Tensor, A: torch.Tensor,
                         B_coef: torch.Tensor, C_coef: torch.Tensor,
                         x: torch.Tensor, h0: torch.Tensor):
    """(y (B, T, Di), h_T (B, Di, N)), float32, of the selective scan over
    dt (B, T, Di), A (Di, N), B_coef / C_coef (B, T, N), x (B, T, Di) and
    h0 (B, Di, N): CUDA tensors, contiguous, on one device; x float32 or
    bfloat16, everything else float32."""
    global launches
    B, T, Di, N = _check_scan_args(
        (("dt", dt), ("A", A), ("B_coef", B_coef), ("C_coef", C_coef),
         ("x", x), ("h0", h0)))
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


def fused_selective_scan_bwd(dt: torch.Tensor, A: torch.Tensor,
                             B_coef: torch.Tensor, C_coef: torch.Tensor,
                             x: torch.Tensor, h0: torch.Tensor,
                             dy: torch.Tensor, dh_T: torch.Tensor):
    """The gradient of :func:`fused_selective_scan`: (d_dt, d_A, d_B, d_C,
    d_x, d_h0) from its inputs and the gradients dy (B, T, Di) and dh_T
    (B, Di, N) of its outputs, float32 CUDA tensors like the inputs. d_x
    is in x's type (rounded once from float32), every other gradient
    float32. T and B must be positive. One launch of the backward and one
    of its reduction of the per-block partials; the scratch (the states
    at the library's checkpoint interval, the partials) is allocated
    here."""
    global bwd_launches
    B, T, Di, N = _check_scan_args(
        (("dt", dt), ("A", A), ("B_coef", B_coef), ("C_coef", C_coef),
         ("x", x), ("h0", h0), ("dy", dy), ("dh_T", dh_T)))
    if B == 0 or T == 0:
        raise ValueError(f"the backward takes B, T > 0, got {(B, T)}")
    grads = tuple(torch.empty_like(t) for t in (dt, A, B_coef, C_coef, x, h0))
    if Di == 0:
        return grads
    lib = _load_bwd()
    nblk = -(-Di // lib.ssm_scan_bwd_channels_per_block(N))
    n_ckpt = max(-(-T // lib.ssm_scan_bwd_chunk()) - 1, 1)
    f32 = dict(dtype=torch.float32, device=dt.device)
    ckpt = torch.empty((B, n_ckpt, Di, N), **f32)
    part_bc = torch.empty((B, nblk, T, 2 * N), **f32)
    part_a = torch.empty((B, Di, N), **f32)
    with torch.cuda.device(dt.device):
        stream = torch.cuda.current_stream(dt.device).cuda_stream
        rc = lib.ssm_scan_bwd_launch(
            *(t.data_ptr() for t in (dt, A, B_coef, C_coef, x, h0, dy, dh_T,
                                     *grads, ckpt, part_bc, part_a)),
            B, T, Di, N, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError("fused_selective_scan_bwd launch failed: "
                           + lib.ssm_scan_bwd_error_string(rc).decode())
    bwd_launches += 1
    return grads
