"""§III-B microbenchmark on the port: wall-clock cost of the custom
collective schedules (ring AllGather, bidirectional ring, ring AllReduce
with and without kernel 2, linear and pairwise AlltoAll, incast) against
the native one-shot collectives, on 8 ranks of one process group, as
``benchmarks/collective_bench.py`` is for the JAX package.

``PYTHONPATH=src python -m benchmarks.pt_collective_bench [--force]
[--device cpu] [--backend gloo|nccl] [--cache-dir DIR]``

The ranks run on the card unless ``--device`` names another. The
transport is the caller's: ``gloo`` (the default; every rank on one card;
point-to-point sends of CUDA tensors staged through the host,
``core.collectives.stage``) or ``nccl`` (one card per rank; it raises
with fewer cards). Sizes are the
registry's (``collective_microbench``: 32 KiB and 2 MiB of float32 a
vector). A call's time is the slowest rank's mean over ``ITERS`` calls
after one warm-up, started together after a barrier. Rows go to
``artifacts/bench_cache_torch/<device type>/collective_bench.csv``.
"""
from __future__ import annotations

import argparse
import time

import torch

from benchmarks.pt_common import (cached_sweep, default_cache_dir,
                                  device_name, size_label)
from repro_torch.core import collectives as C
from repro_torch.core import scenarios
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.launch.mesh import spawn_group

N_RANKS = 8
ITERS = 30


def _native_all_reduce(x, group):
    out = x.clone()
    torch.distributed.all_reduce(out, group=group)
    return out


# (name, input: "shard" (d,) or "matrix" (n, d / n), fn(x, group))
CASES = (
    ("ring_all_gather", "shard", C.ring_all_gather),
    ("bidir_ring_all_gather", "shard",
     lambda x, g: C.ring_all_gather(x, g, bidirectional=True)),
    ("native_all_gather", "shard", C.all_gather),
    ("ring_all_reduce", "matrix", C.ring_all_reduce),
    ("ring_all_reduce_kernel2", "matrix",
     lambda x, g: C.ring_all_reduce(x, g, add=C.fused_add)),
    ("native_all_reduce", "matrix", _native_all_reduce),
    ("linear_all_to_all", "matrix", C.linear_all_to_all),
    ("pairwise_all_to_all", "matrix", C.pairwise_all_to_all),
    ("incast_gather", "matrix", C.incast_gather),
)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_rank(ctx, sizes, iters=ITERS):
    """One rank's timings: {size: {case: µs a call}} (spawn_group)."""
    n, dev = ctx.size, ctx.device
    out = {}
    for size in sizes:
        d = max(size // 4 // n, 8)
        inputs = {"shard": torch.zeros(d, device=dev),
                  "matrix": torch.zeros(n, max(d // n, 1), device=dev)}
        row = {}
        for name, kind, fn in CASES:
            x = inputs[kind]
            fn(x, None)  # warm-up
            _sync(dev)
            torch.distributed.barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                y = fn(x, None)
            _sync(dev)
            row[name] = (time.perf_counter() - t0) / iters * 1e6
            del y
        out[size] = row
    return out


def run_sizes(sizes, device, backend="gloo", iters=ITERS) -> list:
    """{case: µs a call} per size, the slowest rank's, from one spawn of
    ``N_RANKS`` ranks."""
    ranks = spawn_group(bench_rank, N_RANKS, backend=backend,
                        device=device, args=(list(sizes), iters))
    return [{name: max(r[s][name] for r in ranks) for name, *_ in CASES}
            for s in sizes]


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None, backend: str = "gloo"):
    device = resolve_device(device)
    sizes = list(scenarios.get("collective_microbench",
                               quick).microbench_sizes)
    batch = {}

    def row(size):
        # the first size the cache lacks runs every size in one spawn
        if not batch:
            batch.update(zip(sizes, run_sizes(sizes, device, backend)))
        return {"backend": backend, "device": device_name(device),
                **{k: round(v, 1) for k, v in batch[size].items()}}

    rows = cached_sweep("collective_bench", ["size"], [(s,) for s in sizes],
                        row, cache_dir=cache_dir or default_cache_dir(device),
                        force=force)
    print(f"\n# §III-B — custom collective schedules, {N_RANKS} ranks over "
          f"{rows[0]['backend']} on {rows[0]['device']} (us/call)")
    cases = [name for name, *_ in CASES]
    print(f"{'size':>8} " + " ".join(f"{c:>24}" for c in cases))
    for r in rows:
        print(f"{size_label(r['size']):>8} "
              + " ".join(f"{float(r[c]):>24.1f}" for c in cases))
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default=None)
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    p.add_argument("--cache-dir", default=None)
    a = p.parse_args()
    main(force=a.force, device=a.device, cache_dir=a.cache_dir,
         backend=a.backend)
