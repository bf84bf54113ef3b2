"""Wrappers for the hand-written CUDA flash attention (kernel 7) and its
backward.

Each direction has two sources, picked by the inputs' type: bfloat16 runs
on the wgmma kernels of ``csrc/flash_attention_sm90.cu`` and
``csrc/flash_attention_bwd_sm90.cu`` (tensor cores, TMA-fed tiles);
float32 on ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
(float32 CUDA cores, which the float32 reference checks need). Each is
compiled with nvcc for ``sm_90a`` (``_build``, into ``build/`` at first
use) and called through ``ctypes`` on PyTorch's current stream. The
forward replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` and adds the models'
sliding-window mask and an optional row log-sum-exp; the backward has no
TPU counterpart (XLA differentiates the JAX package's attention).
``kernels/ref.py::flash_attention`` and ``flash_attention_bwd`` are their
plain versions.

The wrappers only take CUDA tensors and never fall back: a device, type,
head size, shape or layout a kernel does not take raises, and the type
alone picks the source. ``launches`` counts the forward launches and
``bwd_launches`` the backward ones (one a call, though a call runs two
passes), of either type, since import (or since a caller reset them);
``sm90_launches`` and ``sm90_bwd_launches`` count the bfloat16 ones among
them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# float32 sources, and the bfloat16 (wgmma) ones
SOURCE = _build.CSRC / "flash_attention.cu"
BWD_SOURCE = _build.CSRC / "flash_attention_bwd.cu"
SM90_SOURCE = _build.CSRC / "flash_attention_sm90.cu"
SM90_BWD_SOURCE = _build.CSRC / "flash_attention_bwd_sm90.cu"
# fused multiply-adds on: the dot products gain accuracy from them
FLAGS = tuple(f for f in _build.NVCC_FLAGS if f != "--fmad=false")
DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 64, 96, 112, 128)  # the kernels' template instances
# the bfloat16 backward's heads a dK/dV block (csrc/flash_attention_bwd_sm90.cu
# kHeadsABlock): above it the heads of a KV head are split over blocks,
# whose float32 sums land in a workspace the wrapper allocates
BWD_HEADS_A_BLOCK = 8

launches = 0
bwd_launches = 0
sm90_launches = 0
sm90_bwd_launches = 0
_libs: dict = {}


def _load_source(source, n_ptr: int):
    """The library of ``source``, its launch function taking ``n_ptr``
    pointers, eight ints and the stream."""
    if source not in _libs:
        lib = _build.load(source, FLAGS)
        fn = getattr(lib, f"{source.stem}_launch")
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{source.stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[source] = lib
    return _libs[source]


def _load():
    return _load_source(SOURCE, 5)


def _load_bwd():
    return _load_source(BWD_SOURCE, 9)


def _load_sm90():
    return _load_source(SM90_SOURCE, 5)


def _load_sm90_bwd():
    return _load_source(SM90_BWD_SOURCE, 11)


def _launch(source, n_ptr, *args):
    """Calls ``source``'s launch function on PyTorch's current stream and
    raises with the CUDA error when it does not return 0."""
    lib = _load_source(source, n_ptr)
    rc = getattr(lib, f"{source.stem}_launch")(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"{source.stem} launch failed: "
            + getattr(lib, f"{source.stem}_error_string")(rc).decode())


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
    global launches, sm90_launches
    B, Sq, Skv, H, KH, D = _check_qkv(q, k, v, window)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    if out.numel():
        bf16 = q.dtype == torch.bfloat16
        with torch.cuda.device(q.device):
            _launch(SM90_SOURCE if bf16 else SOURCE, 5, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr() if return_lse else None, B, Sq, Skv, H,
                    KH, D, int(causal), int(window))
        launches += 1
        sm90_launches += bf16
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``o``, its
    row log-sum-exp ``lse`` (B, H, Sq) float32 and the output gradient
    ``do`` (all CUDA, contiguous, q's type but lse). delta = rowsum(dO * O)
    in float32 is formed by a first kernel in bfloat16 and here in
    float32; the kernels' two passes run on it. In bfloat16 with more than
    BWD_HEADS_A_BLOCK query heads a KV head, dK and dV are summed by head
    chunks into a float32 workspace allocated here."""
    global bwd_launches, sm90_bwd_launches
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
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() and k.numel():
        dims = (B, Sq, Skv, H, KH, D, int(causal), int(window))
        with torch.cuda.device(q.device):
            if q.dtype == torch.bfloat16:  # the kernel forms delta itself
                delta = torch.empty((B, H, Sq), dtype=torch.float32,
                                    device=q.device)
                n_split = -(-(H // KH) // BWD_HEADS_A_BLOCK)
                part = torch.empty((2 * n_split, B, Skv, KH, D),
                                   dtype=torch.float32, device=q.device) \
                    if n_split > 1 else None
                _launch(SM90_BWD_SOURCE, 11, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), o.data_ptr(), do.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(),
                        part.data_ptr() if part is not None else None,
                        *dims)
                sm90_bwd_launches += 1
            else:
                delta = (do.float() * o.float()).sum(-1).transpose(
                    1, 2).contiguous()
                _launch(BWD_SOURCE, 9, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                        dv.data_ptr(), *dims)
        bwd_launches += 1
    else:
        dq.zero_(), dk.zero_(), dv.zero_()
    return dq, dk, dv
