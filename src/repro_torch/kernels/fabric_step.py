"""Wrapper for the hand-written CUDA fabric-step kernel.

``csrc/fabric_step.cu`` is compiled with nvcc for ``sm_90a`` into a shared
library with a plain C interface (``build/`` at the repository root, at
first use, by ``_build``) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernel
``repro/kernels/fabric_step.py::fabric_step_core``;
``kernels/ref.py::fabric_step_core`` is its plain version, and this
wrapper has the same signature and return dict.

The wrapper only takes CUDA tensors and never falls back: a shape, type
or shared-memory size the kernel does not take raises. ``launches``
counts the kernel launches since import (or since a caller reset it).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "fabric_step.cu"
FLAGS = _build.NVCC_FLAGS
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
THREADS = 1024

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.fabric_step_core_launch
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 \
            + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.fabric_step_error_string.argtypes = [ctypes.c_int]
        lib.fabric_step_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(L1: int, n_src: int, n_sw: int, with_aux: bool) -> int:
    """Dynamic shared memory of one block: src_load, hot_q/tot_q/sw_sat,
    caps_eff/load/arrival (+ served with aux), 4 bytes each."""
    return 4 * (n_src + 3 * n_sw + (4 if with_aux else 3) * L1)


def check_smem(L1: int, n_src: int, n_sw: int, with_aux: bool) -> int:
    """The block's shared-memory bytes, or ValueError above Hopper's
    227 KB per block (4096-node LUMI without aux needs about 203 KB)."""
    smem = smem_bytes(L1, n_src, n_sw, with_aux)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fabric_step_core needs {smem} bytes of shared memory per "
            f"block (L+1={L1}, n_src={n_src}, n_sw={n_sw}, aux={with_aux}); "
            f"Hopper allows {SMEM_LIMIT}")
    return smem


def _stride(x: torch.Tensor, B: int, n: int, name: str) -> int:
    """Batch stride of a row operand: 0 when one row is shared by every
    cell, n when each cell has its own."""
    if x.dim() == 1 and x.shape[0] == n:
        return 0
    if x.dim() == 2 and tuple(x.shape) == (B, n):
        return n
    raise ValueError(f"{name}: expected ({n},) or ({B}, {n}), "
                     f"got {tuple(x.shape)}")


def pack_scalars(dt, qmax_bytes, hol_factor, hol_start,
                 burst_jitter) -> torch.Tensor:
    """The kernel's (B, 5) block of per-cell scalars, in argument order."""
    return torch.stack([dt, qmax_bytes, hol_factor, hol_start, burst_jitter],
                       1).to(torch.float32).contiguous()


def fabric_step_core(plinks, inject, src_id, host_caps, q, occ, caps_finite,
                     src_sw, dst_sw, dt, qmax_bytes, hol_factor, hol_start,
                     burst_jitter, *, n_src: int, n_sw: int,
                     with_aux: bool = False, scalars=None):
    """One launch of the fused step core for all B cells (grid = B).

    ``scalars`` is :func:`pack_scalars` of the five scalar arguments; a
    caller that launches many steps with the same parameters packs them
    once and passes the block, else each launch packs them."""
    global launches
    B, F, H = plinks.shape
    L1 = q.shape[1]
    ints = {"plinks": plinks, "src_id": src_id, "src_sw": src_sw,
            "dst_sw": dst_sw}
    floats = {"inject": inject, "host_caps": host_caps, "q": q, "occ": occ,
              "caps_finite": caps_finite}
    for name, x in {**ints, **floats}.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.int32 if name in ints else torch.float32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
    if tuple(inject.shape) != (B, F) or tuple(occ.shape) != (B, L1) \
            or tuple(q.shape) != (B, L1):
        raise ValueError("inject must be (B, F), q and occ (B, L+1)")
    strides = (_stride(src_id, B, F, "src_id"),
               _stride(host_caps, B, F, "host_caps"),
               _stride(caps_finite, B, L1, "caps_finite"),
               _stride(src_sw, B, L1, "src_sw"),
               _stride(dst_sw, B, L1, "dst_sw"))
    smem = check_smem(L1, n_src, n_sw, with_aux)
    if scalars is None:
        scalars = pack_scalars(dt, qmax_bytes, hol_factor, hol_start,
                               burst_jitter)
    if tuple(scalars.shape) != (B, 5) or scalars.dtype != torch.float32 \
            or not scalars.is_contiguous() or scalars.device != inject.device:
        raise ValueError("dt, qmax_bytes, hol_factor, hol_start and "
                         "burst_jitter must each be (B,), packed into a "
                         "contiguous float32 (B, 5) block on inject's "
                         "device")
    dev = inject.device

    def out(n):
        return torch.empty((B, n), dtype=torch.float32, device=dev)

    inject_s, achieved = out(F), out(F)
    arrival, q_new, caps_eff = out(L1), out(L1), out(L1)
    served = out(L1) if with_aux else None
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fabric_step_core_launch(
            plinks.data_ptr(), inject.data_ptr(), src_id.data_ptr(),
            host_caps.data_ptr(), q.data_ptr(), occ.data_ptr(),
            caps_finite.data_ptr(), src_sw.data_ptr(), dst_sw.data_ptr(),
            scalars.data_ptr(), inject_s.data_ptr(), achieved.data_ptr(),
            arrival.data_ptr(), q_new.data_ptr(), caps_eff.data_ptr(),
            served.data_ptr() if with_aux else None,
            B, F, H, L1, n_src, n_sw, *strides, int(with_aux), smem,
            THREADS, stream)
    if rc != 0:
        raise RuntimeError("fabric_step_core launch failed: "
                           + lib.fabric_step_error_string(rc).decode())
    launches += 1
    return {"inject": inject_s, "achieved": achieved, "arrival": arrival,
            "q_new": q_new, "caps_eff": caps_eff,
            "served_stage_max": served}
