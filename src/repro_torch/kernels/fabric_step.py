"""Wrapper for the hand-written CUDA fabric-step kernel.

``csrc/fabric_step.cu`` is compiled with nvcc for ``sm_90a`` into a shared
library with a plain C interface (``build/`` at the repository root, at
first use, by ``_build``) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernel
``repro/kernels/fabric_step.py::fabric_step_core``;
``kernels/ref.py::fabric_step_core`` is its plain version, and this
wrapper has the same signature and return dict.

The kernel runs each cell on a cluster of blocks whose size, like the
block's thread count, :func:`launch_config` picks from the cell's shapes
alone, so the order of every segment sum (the source's header note) does
not depend on the batch. The wrapper only takes CUDA tensors and never
falls back: a shape, type or shared-memory size the kernel does not take
raises. ``launches`` counts the kernel launches since import (or since a
caller reset it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SOURCE = _build.CSRC / "fabric_step.cu"
FLAGS = _build.NVCC_FLAGS
# dynamic shared memory one block may use on Hopper (227 KB)
SMEM_LIMIT = 232448
# the source's constants: the longest segment part one thread sums (a
# longer one is a warp's), flows a block takes before a cell spreads over
# a cluster, the cluster sizes (portable ones), the block of a cell and of
# a small one (at most SMALL_CELL hop items, flows and links a block)
SERIAL_MAX = 8
FLOWS_PER_BLOCK = 2048
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_THREADS = 512
SMALL_THREADS = 128
SMALL_CELL = 1024
# the most flows a cell may have: a cluster of the largest size, each
# block holding its flows' hop items in shared memory
MAX_FLOWS = CLUSTER_SIZES[-1] * FLOWS_PER_BLOCK
# the fields of the source's `Layout`, in order: a block's rows in dynamic
# shared memory, then the total (word offsets; the launch passes them)
LAYOUT_FIELDS = (
    "ws", "small", "items", "segs", "longl", "longb", "spl", "r", "hcap",
    "sid", "q", "sat", "ce", "arr", "ovr", "smax", "srcp", "srcl", "swp",
    "stall", "tmp", "ssw", "boff", "scr", "ord", "part", "spart", "touch",
    "list", "total")
# fabric_step_core_launch: 16 pointers, B F H L1 n_src n_sw, five batch
# strides, with_aux threads cluster, the layout, the stream
ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 6 \
    + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]

launches = 0
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load(SOURCE, FLAGS)
        fn = lib.fabric_step_core_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        lib.fabric_step_error_string.argtypes = [ctypes.c_int]
        lib.fabric_step_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def smem_bytes(L1: int, n_src: int, n_sw: int, with_aux: bool) -> int:
    """Shared memory a cell's rows took in one block before the cluster
    layout: src_load, hot_q/tot_q/sw_sat, caps_eff/load/arrival (+ served
    with aux), 4 bytes each. :func:`check_smem` gates shapes on it."""
    return 4 * (n_src + 3 * n_sw + (4 if with_aux else 3) * L1)


def check_smem(L1: int, n_src: int, n_sw: int, with_aux: bool) -> int:
    """:func:`smem_bytes`, or ValueError above Hopper's 227 KB per block
    (4096-node LUMI without aux needs about 203 KB): the shapes the kernel
    takes, as it took them when one block held a cell's rows."""
    smem = smem_bytes(L1, n_src, n_sw, with_aux)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fabric_step_core needs {smem} bytes of shared memory per "
            f"block (L+1={L1}, n_src={n_src}, n_sw={n_sw}, aux={with_aux}); "
            f"Hopper allows {SMEM_LIMIT}")
    return smem


class BlockShape(NamedTuple):
    """What one block of a cell's cluster holds (``make_shape`` in the
    source): flows, links, sources and switches it owns, the hop items it
    sorts (nf * H), and an item's index and key bits."""
    nf: int
    nl: int
    ns: int
    nw: int
    n_items: int
    ib: int
    kb: int


def block_shape(F: int, H: int, L1: int, n_src: int, n_sw: int,
                cluster: int) -> BlockShape:
    def per(n):
        return -(-n // cluster)
    nf, nl = per(F), per(L1)
    return BlockShape(nf, nl, per(n_src), per(n_sw), nf * H,
                      (nf - 1).bit_length(), (H * L1).bit_length())


def smem_layout(F: int, H: int, L1: int, n_src: int, n_sw: int,
                cluster: int, with_aux: bool) -> tuple:
    """The word offsets of :data:`LAYOUT_FIELDS`, the last the total: the
    only description of a block's shared memory (the kernel takes it from
    the launch). The rows every phase keeps come first; the grouping
    scratch of the prologue and a cluster's hop tables then share one
    stretch."""
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    N, nf, nl, C = s.n_items, s.nf, s.nl, cluster
    cl = C > 1
    kept = (("ws", 256 * 16 + 40),  # sort counts by digit and warp; scans
            ("small", 4 * (H + 1) + 4), ("items", N), ("segs", N + 1),
            ("longl", N // (SERIAL_MAX + 1) + 1),
            ("longb", (nf + nl) // (SERIAL_MAX + 1) + 1),
            ("spl", N),  # the block's path table, hop-major [H][nf]
            ("r", nf), ("hcap", nf), ("sid", nf),
            ("q", nl), ("sat", nl), ("ce", nl), ("arr", nl), ("ovr", nl),
            ("smax", nl if with_aux else 0),
            ("srcp", C * s.ns), ("srcl", s.ns),
            ("swp", 3 * C * s.nw), ("stall", s.nw))
    grouping = (("tmp", N), ("ssw", nl), ("boff", n_src + n_sw + 1),
                ("scr", nf + nl), ("ord", nf + nl))
    hops = (("part", C * nl if cl else 0),
            ("spart", C * nl if cl and with_aux else 0),
            ("touch", nl if cl else 0), ("list", 2 * nl if cl else 0))
    off, o = {}, 0

    def place(rows, o):
        for name, words in rows:
            off[name] = o
            o += words
        return o
    shared = place(kept, 0)
    o = max(place(grouping, shared), place(hops, shared))
    off["total"] = o
    return tuple(off[name] for name in LAYOUT_FIELDS)


class LaunchConfig(NamedTuple):
    grid: int      # blocks: B cells x cluster
    threads: int   # threads a block
    cluster: int   # blocks a cell
    smem: int      # dynamic shared memory a block, bytes
    layout: tuple  # word offsets of LAYOUT_FIELDS (:func:`smem_layout`)


def _fits(F, H, L1, n_src, n_sw, cluster, with_aux) -> bool:
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    return s.n_items < 65536 and s.ib + s.kb <= 31 and 4 * smem_layout(
        F, H, L1, n_src, n_sw, cluster, with_aux)[-1] <= SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _cell_config(F, H, L1, n_src, n_sw, with_aux):
    """(threads, cluster, layout, the layout as a ctypes int array) of a
    cell of these shapes; cached, so a step pays one lookup."""
    check_smem(L1, n_src, n_sw, with_aux)
    if F > MAX_FLOWS:
        raise ValueError(
            f"fabric_step_core takes at most {MAX_FLOWS} flows a cell (a "
            f"cluster of {CLUSTER_SIZES[-1]} blocks of {FLOWS_PER_BLOCK}), "
            f"got F={F}")
    least = -(-F // FLOWS_PER_BLOCK)
    sizes = [c for c in CLUSTER_SIZES if c >= least]
    cluster = next((c for aux in (True, False) for c in sizes
                    if _fits(F, H, L1, n_src, n_sw, c, aux)), None)
    if cluster is None or not _fits(F, H, L1, n_src, n_sw, cluster,
                                     with_aux):
        raise ValueError(
            f"fabric_step_core: no cluster of {CLUSTER_SIZES} holds a cell "
            f"of F={F}, H={H}, L+1={L1}, n_src={n_src}, n_sw={n_sw} "
            f"(aux={with_aux}) in {SMEM_LIMIT} bytes a block, with fewer "
            f"than 65536 hop items a block and item keys of 31 bits")
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    threads = MAX_THREADS if s.n_items + s.nf + s.nl > SMALL_CELL \
        else SMALL_THREADS
    layout = smem_layout(F, H, L1, n_src, n_sw, cluster, with_aux)
    return threads, cluster, layout, (ctypes.c_int * len(layout))(*layout)


def launch_config(B: int, F: int, H: int, L1: int, n_src: int, n_sw: int,
                  with_aux: bool = False) -> LaunchConfig:
    """The launch of B cells of these shapes. The cluster and the block
    depend on (F, H, L+1, n_src, n_sw) alone, never on B or ``with_aux``,
    so each segment sum runs in the same order in any batch: the smallest
    cluster with at most ``FLOWS_PER_BLOCK`` flows a block whose layout
    fits with the aux observer (else without it); ``MAX_THREADS`` threads a
    block, ``SMALL_THREADS`` for a small cell (the phases are
    latency-bound, and more warps hide more of it where there is work for
    them).

    Raises ValueError where :func:`check_smem` does, and also for a cell
    of more than ``MAX_FLOWS`` = 16,384 flows (an alltoall over more than
    128 nodes), or one that no cluster of 8 holds: a block's layout over
    ``SMEM_LIMIT``, 65,536 hop items or more a block, or item keys and
    indices over 31 bits. The kernel before the redesign kept no flow row
    in shared memory and took any F."""
    threads, cluster, layout, _ = _cell_config(F, H, L1, n_src, n_sw,
                                               bool(with_aux))
    return LaunchConfig(B * cluster, threads, cluster, 4 * layout[-1],
                        layout)


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
    """One launch of the fused step core for all B cells, each on the
    cluster :func:`launch_config` picks.

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
    threads, cluster, _, c_layout = _cell_config(F, H, L1, n_src, n_sw,
                                                 bool(with_aux))
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
            B, F, H, L1, n_src, n_sw, *strides, int(with_aux), threads,
            cluster, c_layout, stream)
    if rc != 0:
        raise RuntimeError("fabric_step_core launch failed: "
                           + lib.fabric_step_error_string(rc).decode())
    launches += 1
    return {"inject": inject_s, "achieved": achieved, "arrival": arrival,
            "q_new": q_new, "caps_eff": caps_eff,
            "served_stage_max": served}
