"""Wrapper for the hand-written CUDA fabric-step kernel.

``csrc/fabric_step.cu`` is compiled with nvcc for ``sm_90a`` into a shared
library with a plain C interface (``build/`` at the repository root, at
first use, by ``_build``) and called through ``ctypes`` on PyTorch's
current stream. It replaces the TPU kernel
``repro/kernels/fabric_step.py::fabric_step_core``;
``kernels/ref.py::fabric_step_core`` is its plain version, and this
wrapper has the same signature and return dict.

The kernel runs each cell on a cluster of blocks whose size, like the
block's thread count and its layout, :func:`launch_config` picks from the
cell's shapes alone, so the order of every segment sum (the source's
header note) does not depend on the batch: a cell's flows fall into
parts of ``FLOWS_PER_PART``, each part's share of a sum is folded on its
own, and the shares are added in part order, whichever block owns a
part. A cell whose rows do not fit a block's shared memory takes the
wide layout: the rows that do not fit live in a global-memory workspace,
one stretch a block, which the wrapper allocates for each launch on the
current stream. The wrapper only takes CUDA tensors and never falls
back: a shape or type the kernel does not take raises. ``launches`` counts the kernel launches since import (or since a
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
# longer one is a warp's), the flows of a part (the unit of summation: a
# cell spreads over a cluster a part a block, and past the largest
# cluster each block owns several consecutive parts), the cluster sizes
# (the portable ones: MAX_CLUSTER), the parts a cell may have (a link's
# mask of the parts that posted to it is 32 bits), the hop items a block
# may sort (its head counts take 17 bits) and the bits of an item's
# (key, index) word; the block of a cell and of a small one (at most
# SMALL_CELL hop items, flows and links a block)
SERIAL_MAX = 8
FLOWS_PER_PART = 2048
CLUSTER_SIZES = (1, 2, 4, 8)
MAX_PARTS = 32
MAX_ITEMS = 65536
KEY_BITS = 32
MAX_THREADS = 512
SMALL_THREADS = 128
SMALL_CELL = 1024
# the most flows a cell may have: MAX_PARTS parts
MAX_FLOWS = MAX_PARTS * FLOWS_PER_PART
# the fields of the source's `Layout`, in order: a block's rows, then the
# words of shared memory and the words of shared memory and workspace
# together (word offsets; the launch passes them). An offset below
# `total` is in dynamic shared memory, one at or past it in the block's
# stretch of the workspace.
LAYOUT_FIELDS = (
    "ws", "small", "items", "segs", "longl", "longb", "spl", "r", "hcap",
    "sid", "q", "sat", "ce", "arr", "ovr", "smax", "srcp", "srcl", "swp",
    "stall", "tmp", "ssw", "boff", "scr", "ord", "part", "spart", "touch",
    "list", "total", "gtotal")
# the rows the wide layout moves to the workspace, in this order, until
# the rest fits: a cluster's hop tables, the grouping scratch, the link
# rows, then the flow and hop-item rows. The block scans' scratch, the
# hop bounds and the source and switch rows (small, and read by peers
# through distributed shared memory) always stay in shared memory.
WIDE_ROWS = ("part", "spart", "list", "touch", "tmp", "scr", "ord", "boff",
             "ssw", "q", "sat", "ce", "arr", "ovr", "smax", "spl", "segs",
             "items", "longl", "longb", "r", "hcap", "sid")
# fabric_step_core_launch: 17 pointers (the 16 operands and outputs, the
# workspace), B F H L1 n_src n_sw, five batch strides, with_aux threads
# cluster, the layout, the stream
ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 \
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


class BlockShape(NamedTuple):
    """What one block of a cell's cluster holds (``make_shape`` in the
    source): flows and parts it owns, links, sources and switches, the
    hop items it sorts (nf * H), and an item's index and key bits. On a
    cluster a block owns ``parts`` parts of ``FLOWS_PER_PART`` flows
    (one up to a cluster's worth of parts, ceil(F / (8 * 2048)) past it)
    whatever else F is, so flow i is part i // 2048's in any cluster:
    flows appended to a cell (a bucket's padding, which adds only exact
    zeros) leave every real flow's part, and so every sum's order, as
    they are."""
    nf: int
    parts: int
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
    parts = max(1, -(-F // (cluster * FLOWS_PER_PART))) if cluster > 1 \
        else 1
    nf = parts * FLOWS_PER_PART if cluster > 1 else F
    return BlockShape(nf, parts, per(L1), per(n_src), per(n_sw), nf * H,
                      (nf - 1).bit_length(), (H * L1).bit_length())


def smem_layout(F: int, H: int, L1: int, n_src: int, n_sw: int,
                cluster: int, with_aux: bool, workspace=()) -> tuple:
    """The word offsets of :data:`LAYOUT_FIELDS`: the only description of
    a block's rows (the kernel takes it from the launch). In shared
    memory the rows every phase keeps come first; the grouping scratch of
    the prologue and a cluster's hop tables then share one stretch. The
    rows named in ``workspace`` are placed one after another past the
    shared total, in the block's stretch of the workspace."""
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    N, nf, nl, C = s.n_items, s.nf, s.nl, cluster
    V = C * s.parts  # the cell's parts
    cl = C > 1
    kept = (("ws", 256 * 16 + 40),  # sort counts by digit and warp; scans
            ("small", 4 * (H + 1) + 4), ("items", N), ("segs", N + 1),
            ("longl", N // (SERIAL_MAX + 1) + 1),
            ("longb", (nf + L1) // (SERIAL_MAX + 1) + 1),
            ("spl", N),  # the block's path table, hop-major [H][nf]
            ("r", nf), ("hcap", nf), ("sid", nf),
            ("q", nl), ("sat", nl), ("ce", nl), ("arr", nl), ("ovr", nl),
            ("smax", nl if with_aux else 0),
            ("srcp", V * s.ns), ("srcl", s.ns),
            ("swp", 3 * s.nw), ("stall", s.nw))
    # the block's flows by part and source and every link of its switches
    # by switch: up to nf + L1 items
    grouping = (("tmp", N), ("ssw", L1),
                ("boff", s.parts * n_src + n_sw + 1),
                ("scr", nf + L1), ("ord", nf + L1))
    hops = (("part", V * nl if cl else 0),
            ("spart", V * nl if cl and with_aux else 0),
            ("touch", nl if cl else 0), ("list", 2 * nl if cl else 0))
    off = {}

    def place(rows, o):
        for name, words in rows:
            if name not in workspace:
                off[name] = o
                o += words
        return o
    shared = place(kept, 0)
    total = max(place(grouping, shared), place(hops, shared))
    off["total"] = o = total
    for name, words in kept + grouping + hops:
        if name in workspace:
            off[name] = o
            o += words
    off["gtotal"] = o
    return tuple(off[name] for name in LAYOUT_FIELDS)


class LaunchConfig(NamedTuple):
    grid: int       # blocks: B cells x cluster
    threads: int    # threads a block
    cluster: int    # blocks a cell
    smem: int       # dynamic shared memory a block, bytes
    layout: tuple   # word offsets of LAYOUT_FIELDS (:func:`smem_layout`)
    workspace: tuple  # the rows in the workspace (empty: shared layout)
    ws_bytes: int   # workspace a block, bytes (0: shared layout)


def _encodes(F, H, L1, n_src, n_sw, cluster) -> bool:
    """A block's hop items fit the kernel's counts (at most MAX_ITEMS)
    and its KEY_BITS-bit (key, index) words."""
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    return s.n_items <= MAX_ITEMS and s.ib + s.kb <= KEY_BITS \
        and s.kb < 32


def _words(F, H, L1, n_src, n_sw, cluster, with_aux, workspace=()) -> int:
    return smem_layout(F, H, L1, n_src, n_sw, cluster, with_aux,
                       workspace)[LAYOUT_FIELDS.index("total")]


@functools.lru_cache(maxsize=None)
def _cell_config(F, H, L1, n_src, n_sw, with_aux, wide=None):
    """(threads, cluster, layout, workspace rows, the layout as a ctypes
    int array) of a cell of these shapes; cached, so a step pays one
    lookup. ``wide`` None picks the layout; True moves every row of
    :data:`WIDE_ROWS` to the workspace at the cluster the shared layout
    would take (its bits are the shared layout's)."""
    if F > MAX_FLOWS:
        raise ValueError(
            f"fabric_step_core takes at most {MAX_FLOWS} flows a cell "
            f"({MAX_PARTS} parts of {FLOWS_PER_PART}: a link's mask of the "
            f"parts that posted to it has {MAX_PARTS} bits), got F={F}")
    least = min(-(-F // FLOWS_PER_PART), CLUSTER_SIZES[-1])
    sizes = [c for c in CLUSTER_SIZES
             if c >= least and _encodes(F, H, L1, n_src, n_sw, c)]
    if not sizes:
        raise ValueError(
            f"fabric_step_core: no cluster of {CLUSTER_SIZES} takes a cell "
            f"of F={F}, H={H}, L+1={L1} with at most {MAX_ITEMS} hop items "
            f"a block and (key, index) words of {KEY_BITS} bits")

    def fits(c, aux, rows=()):
        return 4 * _words(F, H, L1, n_src, n_sw, c, aux, rows) <= SMEM_LIMIT
    cluster = next((c for aux in (True, False) for c in sizes
                    if fits(c, aux)), None)
    rows = ()
    if wide:
        cluster = cluster or sizes[0]
        rows = WIDE_ROWS
    elif cluster is None or not fits(cluster, with_aux):
        # the wide layout, on the cluster the shared one takes without aux
        # (else the smallest), with the fewest rows moved
        cluster = cluster or sizes[0]
        rows = next((WIDE_ROWS[:k] for k in range(1, len(WIDE_ROWS) + 1)
                     if fits(cluster, with_aux, WIDE_ROWS[:k])), None)
        if rows is None:
            raise ValueError(
                f"fabric_step_core: a cell of F={F}, H={H}, L+1={L1}, "
                f"n_src={n_src}, n_sw={n_sw} does not fit {SMEM_LIMIT} "
                f"bytes a block even with its rows in the workspace")
    s = block_shape(F, H, L1, n_src, n_sw, cluster)
    threads = MAX_THREADS if s.n_items + s.nf + s.nl > SMALL_CELL \
        else SMALL_THREADS
    layout = smem_layout(F, H, L1, n_src, n_sw, cluster, with_aux, rows)
    return (threads, cluster, layout, rows,
            (ctypes.c_int * len(layout))(*layout))


def launch_config(B: int, F: int, H: int, L1: int, n_src: int, n_sw: int,
                  with_aux: bool = False, wide=None) -> LaunchConfig:
    """The launch of B cells of these shapes. The cluster and the block
    depend on (F, H, L+1, n_src, n_sw) alone, never on B or ``with_aux``,
    so each segment sum runs in the same order in any batch: the smallest
    cluster with at most one part (``FLOWS_PER_PART`` flows) a block, or
    the largest cluster past that, whose layout fits shared memory with
    the aux observer (else without it);
    ``MAX_THREADS`` threads a block, ``SMALL_THREADS`` for a small cell
    (the phases are latency-bound, and more warps hide more of it where
    there is work for them).

    Where no cluster's shared layout fits, the cell takes the wide
    layout on the smallest cluster (or, where only the aux observer's
    rows do not fit, on the cluster it takes without them): the leading
    rows of
    :data:`WIDE_ROWS` move to a global-memory workspace until the rest
    fits (the paper's wide alltoall cells, e.g. LUMI at 128 and 256
    nodes). Only the memory a row lives in changes, never an operation
    or its order, so a cell both layouts take gives the same bits in
    both (``wide=True`` forces the wide layout, for that check).

    A cell of more than 8 parts (16,384 flows: an alltoall over more than
    256 nodes) runs on a cluster of 8 whose blocks own ceil(F / 16,384)
    consecutive parts each, and take the wide layout at the paper's
    shapes (``scale_sweep``'s 512-node alltoall cells: 65,536 flows, four
    parts a block). Each part's share of a sum is folded on its own and
    the shares are added in part order, as on a cluster of a part a
    block, so a cell padded to more parts keeps its bits.

    Raises ValueError for a cell of more than ``MAX_FLOWS`` = 65,536
    flows (``MAX_PARTS`` parts), or one whose hop items no cluster
    encodes (more than ``MAX_ITEMS`` = 65,536 a block, e.g. 65,536 flows
    of more than 8 hops, or (key, index) words over ``KEY_BITS`` = 32
    bits)."""
    threads, cluster, layout, rows, _ = _cell_config(
        F, H, L1, n_src, n_sw, bool(with_aux), wide)
    total, gtotal = layout[-2], layout[-1]
    return LaunchConfig(B * cluster, threads, cluster, 4 * total, layout,
                        rows, 4 * (gtotal - total))


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
                     with_aux: bool = False, scalars=None, wide=None):
    """One launch of the fused step core for all B cells, each on the
    cluster and layout :func:`launch_config` picks (``wide`` as there).

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
    threads, cluster, layout, _, c_layout = _cell_config(
        F, H, L1, n_src, n_sw, bool(with_aux), wide)
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
    # the wide layout's rows: each block's stretch is written before it is
    # read in the launch, so the buffer needs no clearing
    ws_words = B * cluster * (layout[-1] - layout[-2])
    ws = torch.empty(ws_words, dtype=torch.int32, device=dev) \
        if ws_words else None
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
            ws.data_ptr() if ws_words else None,
            B, F, H, L1, n_src, n_sw, *strides, int(with_aux), threads,
            cluster, c_layout, stream)
    if rc != 0:
        raise RuntimeError("fabric_step_core launch failed: "
                           + lib.fabric_step_error_string(rc).decode())
    launches += 1
    return {"inject": inject_s, "achieved": achieved, "arrival": arrival,
            "q_new": q_new, "caps_eff": caps_eff,
            "served_stage_max": served}
