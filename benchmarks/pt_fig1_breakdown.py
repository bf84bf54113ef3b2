"""Paper Fig. 1 on the port: time distribution of a custom ring AllReduce.

The paper's finding: a custom ring AllReduce (ReduceScatter + AllGather)
loses bandwidth to *reduction costs and memory handling* (buffer setup +
memcpy), not to the network, which is why the congestion study leaves
computation collectives out (§III-B).

Reproduction, as ``benchmarks/fig1_breakdown.py`` does it for the JAX
package: time the ring AllReduce's compute phases on the device (an add
of the d/n chunk per reduce step; a copy of it per send/recv staging
step) and the fused receive-accumulate kernel (``ops.fused_accumulate``,
``csrc/fused_reduce.cu`` on the card), beside the simulated wire time of
the same vector on the HAICGU EDR fabric (``bench.run_grid`` through the
port's engine, every size's cells one batch). On the card the compute phases are device times: 20
calls captured once in a CUDA graph, its replays timed with CUDA events
(the median of 5), so the host's dispatch cost is not in them; on the
CPU they are host-clock times.

``PYTHONPATH=src python -m benchmarks.pt_fig1_breakdown [--quick]
[--force] [--device cpu]``
"""
from __future__ import annotations

import argparse
import time

import torch

from benchmarks.pt_common import (cached_sweep, default_cache_dir,
                                  device_name, size_label)
from repro_torch.core import bench, congestion as cong, scenarios
from repro_torch.core.collectives import wire_bytes_model
from repro_torch.core.fabric import systems
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.kernels import ops

N_NODES = 8
ITERS = 20
REPLAYS = 5
TILE_COLS = 512


def _graph_time_s(fn, device: torch.device, iters: int) -> float:
    """Device seconds per call of ``fn``: ``iters`` calls captured in one
    CUDA graph (after a warm-up call on a side stream), each replay timed
    between CUDA events; the median of REPLAYS replays, all enqueued
    behind a device-side sleep so no event pair spans host launch time."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    torch.cuda._sleep(50_000_000)  # ~25 ms at H100 clocks
    pairs = []
    for _ in range(REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(device)
    ms = sorted(s.elapsed_time(e) for s, e in pairs)[REPLAYS // 2]
    return ms / 1e3 / iters


def _time_s(fn, device: torch.device, iters: int = ITERS) -> float:
    """Seconds per call of ``fn``: device time from CUDA-graph replays on
    the card, the host clock around ``iters`` calls after a warm-up call
    on the CPU."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return _graph_time_s(fn, device, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def fused_tile(vector_bytes: float) -> tuple:
    """(rows, 512) float32 tile of one rank's d/n chunk, as the reference
    driver shapes the fused kernel's operands."""
    d = int(vector_bytes) // 4
    return (max(d // N_NODES // TILE_COLS, 1), TILE_COLS)


def run_sizes(sizes, device=None) -> list:
    """One row per vector size: the compute phases timed per size, and
    the simulated network time of every size from one batched grid on
    the HAICGU EDR fabric (``bench.run_grid``: each size's uncongested
    cells, uncongested EDR, the paper's nodes)."""
    device = resolve_device(device)
    n = N_NODES
    sizes = [float(v) for v in sizes]
    nets = bench.run_grid(*network_grid(sizes), n_iters=15, warmup=3,
                          device=device)
    rows = []
    for vector_bytes, res in zip(sizes, nets):
        d = int(vector_bytes) // 4
        chunk = torch.zeros((max(d // n, 1),), dtype=torch.float32,
                            device=device)
        recv = torch.ones_like(chunk)
        t_add = _time_s(lambda: torch.add(chunk, recv), device) * (n - 1)
        t_copy = _time_s(lambda: chunk.clone(), device) * 2 * (n - 1)
        acc2 = torch.zeros(fused_tile(vector_bytes), dtype=torch.float32,
                           device=device)
        x2 = torch.ones_like(acc2)
        t_fused = _time_s(lambda: ops.fused_accumulate(acc2, x2),
                          device) * (n - 1)
        t_net = res.t_uncongested_s
        total = t_add + t_copy + t_net
        rows.append({
            "t_reduce_us": t_add * 1e6,
            "t_memcpy_us": t_copy * 1e6,
            "t_network_us": t_net * 1e6,
            "t_fused_reduce_us": t_fused * 1e6,
            "compute_fraction": (t_add + t_copy) / total,
            "wire_bytes": wire_bytes_model("ring_all_reduce", n,
                                           vector_bytes)["bytes"],
            "n_iters": res.n_iters,
            "device": device_name(device),
        })
    return rows


def network_grid(sizes) -> tuple:
    """The positional arguments of the one bench.run_grid (and
    bench.grid_inputs) that :func:`run_sizes` runs: uncongested EDR, the
    paper's nodes, a baseline and an uncongested cell a size."""
    return (systems.get_system("haicgu_ib"), N_NODES, "ring_allreduce", "",
            [float(v) for v in sizes], [cong.no_congestion()])


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None):
    device = resolve_device(device)
    points = list(scenarios.get("fig1_breakdown", quick).points)
    sizes = [v for v, in points]
    batch = {}

    def row(v):
        # the first size the cache lacks runs every size as one batch
        if not batch:
            batch.update(zip(sizes, run_sizes(sizes, device)))
        return batch[v]
    rows = cached_sweep("fig1_breakdown", ["vector_bytes"], points, row,
                        cache_dir=cache_dir or default_cache_dir(device),
                        force=force)
    print("\n# Fig. 1 — ring AllReduce cost breakdown "
          f"({N_NODES} nodes, EDR sim + compute on {device_name(device)})")
    print(f"{'size':>8} {'reduce_us':>11} {'memcpy_us':>11} "
          f"{'network_us':>11} {'fused_us':>10} {'compute%':>9}")
    for r in rows:
        print(f"{size_label(r['vector_bytes']):>8} "
              f"{float(r['t_reduce_us']):>11.1f} "
              f"{float(r['t_memcpy_us']):>11.1f} "
              f"{float(r['t_network_us']):>11.1f} "
              f"{float(r['t_fused_reduce_us']):>10.1f} "
              f"{100 * float(r['compute_fraction']):>8.1f}%")
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--force", action="store_true")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(force=a.force, quick=a.quick, device=a.device)
