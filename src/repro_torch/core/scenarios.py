"""Declarative scenario registry: named sweeps over the batched engine.

A :class:`Scenario` is a list of :class:`Grid` specs (each one
``bench.run_grid`` call: one flow set, every size x profile x
baseline/congested cell batched; or, with ``cells``, one scale-batched
``bench.run_scale_grid`` call) or a tuple of ``points`` that a benchmark
script interprets. The port registers the paper's figures: Fig. 1 (ring
AllReduce breakdown), Fig. 3 (self-congestion sawtooth), Fig. 4 (NSLB
on/off), Fig. 5 (steady congestion at scale), Fig. 6 (bursty congestion)
and Figs. 7-8 (bursty congestion at larger scale).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

from repro_torch.core import bench
from repro_torch.core import congestion as cong
from repro_torch.core.envelopes import Profile
from repro_torch.core.fabric import systems
from repro_torch.core.traffic import JobSpec

KiB = 2 ** 10
MiB = 2 ** 20


@dataclasses.dataclass(frozen=True)
class Grid:
    """One flow-program's worth of cells: sizes x profiles (plus the
    implied per-size baselines), batched by bench.run_grid. ``cells``, a
    tuple of ``(system, n_nodes)`` pairs, makes the grid scale-batched
    (bench.run_scale_grid: geometries padded into one bucket);
    ``system``/``n_nodes`` are then a label and 0."""

    system: str
    n_nodes: int
    aggressor: str
    sizes: Tuple[float, ...]
    profiles: Tuple[Profile, ...]
    victim: str = "ring_allgather"
    phased: bool = False
    jobs: Tuple[JobSpec, ...] = ()
    cells: Tuple[Tuple[str, int], ...] = ()


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    grids: Tuple[Grid, ...]
    n_iters: int = 25
    warmup: int = 5
    # non-grid figures (fig4) declare their sweep points here
    points: Tuple[tuple, ...] = ()


SCENARIOS: Dict[str, Callable[[bool], Scenario]] = {}


def register(make: Callable[[bool], Scenario]):
    probe = make(False)
    SCENARIOS[probe.name] = make
    return make


def get(name: str, quick: bool = False) -> Scenario:
    return SCENARIOS[name](quick)


def run_grid_spec(scenario: Scenario, grid: Grid, *, device=None,
                  core=None) -> List[bench.BenchResult]:
    system = list(grid.cells) if grid.cells \
        else systems.get_system(grid.system)
    return bench.run_grid(
        system, grid.n_nodes, grid.victim,
        grid.aggressor, grid.sizes, grid.profiles,
        n_iters=scenario.n_iters, warmup=scenario.warmup,
        phased=grid.phased, jobs=list(grid.jobs) or None, device=device,
        core=core)


def result_row(grid: Grid, r: bench.BenchResult) -> dict:
    """Flatten a BenchResult to the CSV row shape the benchmarks print."""
    row = {
        "system": r.system, "n_nodes": r.n_nodes, "victim": r.victim,
        "aggressor": r.aggressor, "vector_bytes": r.vector_bytes,
        "profile": r.profile,
        "ratio": round(r.ratio, 4),
        "t_uncongested_us": round(r.t_uncongested_s * 1e6, 1),
        "t_congested_us": round(r.t_congested_s * 1e6, 1),
    }
    prof = next((p for p in grid.profiles if p.label() == r.profile), None)
    if prof is not None and prof.kind in ("bursty", "random"):
        row["burst_ms"] = round(prof.burst_s * 1e3, 4)
        row["pause_ms"] = round(prof.pause_s * 1e3, 4)
    if r.job_times:
        row["job_times"] = ";".join(
            f"{name}:{t * 1e6:.1f}us:{n}" for name, t, n in r.job_times)
    return row


# --------------------------------------------------------------------------
# Paper sweeps
# --------------------------------------------------------------------------

FIG5_SYSTEMS = ("cresco8", "leonardo", "lumi")
FIG5_AGGRESSORS = ("alltoall", "incast")
FIG5_NODES = (16, 32, 64, 128, 256)
FIG5_SIZES = (512, 32 * KiB, 2 * MiB, 16 * MiB)

BURSTS_MS = (0.5, 2.0, 8.0)
PAUSES_MS = (0.2, 1.0, 8.0)
FIG6_SIZES = (512, 32 * KiB, 2 * MiB)


def _bursty_grid(bursts_ms, pauses_ms) -> Tuple[Profile, ...]:
    return tuple(cong.bursty(b * 1e-3, p * 1e-3)
                 for b in bursts_ms for p in pauses_ms)


@register
def fig5_steady(quick: bool = False) -> Scenario:
    nodes = (16, 64, 256) if quick else FIG5_NODES
    sizes = (32 * KiB, 2 * MiB) if quick else FIG5_SIZES
    grids = tuple(Grid(s, n, a, sizes, (cong.steady(),))
                  for s in FIG5_SYSTEMS for a in FIG5_AGGRESSORS
                  for n in nodes)
    return Scenario(
        "fig5_steady",
        "Paper Fig. 5 / Obs. 2: steady congestion at scale — ratio heatmaps "
        "(nodes x vector size) per system x aggressor, AllGather victim.",
        grids)


@register
def fig6_bursty(quick: bool = False) -> Scenario:
    sizes = (32 * KiB,) if quick else FIG6_SIZES
    bursts = (0.5, 8.0) if quick else BURSTS_MS
    pauses = (0.2, 8.0) if quick else PAUSES_MS
    grids = tuple(Grid(s, 64, a, sizes, _bursty_grid(bursts, pauses))
                  for s in FIG5_SYSTEMS for a in FIG5_AGGRESSORS)
    return Scenario(
        "fig6_bursty",
        "Paper Fig. 6 / Obs. 3: bursty congestion at 64 nodes — "
        "(burst x pause) duty-cycle heatmaps per system x aggressor x size.",
        grids)


@register
def fig7_fig8_scale(quick: bool = False) -> Scenario:
    """The (system x n_nodes) ladder in one run_scale_grid call per
    aggressor (quick: 2 scales x 2 systems, incast only: the Fig. 7
    claim that a wider congestion tree collapses less)."""
    cells = (("cresco8", 64), ("cresco8", 128),
             ("lumi", 64), ("lumi", 128)) if quick else \
        (("cresco8", 64), ("cresco8", 128), ("lumi", 256))
    sizes = (2 * MiB,) if quick else (32 * KiB, 2 * MiB)
    bursts = (2.0,) if quick else BURSTS_MS
    pauses = (0.2, 8.0) if quick else PAUSES_MS
    aggrs = ("incast",) if quick else FIG5_AGGRESSORS
    grids = tuple(Grid("scale", 0, a, sizes, _bursty_grid(bursts, pauses),
                       cells=cells)
                  for a in aggrs)
    return Scenario(
        "fig7_fig8_scale",
        "Paper Figs. 7-8: bursty congestion at larger scale (CRESCO8 "
        "64/128 nodes, LUMI 256 nodes), scale-batched.",
        grids, n_iters=12 if quick else 20, warmup=3 if quick else 4)


# --------------------------------------------------------------------------
# Non-grid paper figures (fig1/fig3/fig4): the matching benchmark driver
# interprets the ``points`` tuples.
# --------------------------------------------------------------------------


@register
def fig1_breakdown(quick: bool = False) -> Scenario:
    sizes = (MiB, 16 * MiB) if quick else (MiB, 16 * MiB, 128 * MiB)
    return Scenario(
        "fig1_breakdown",
        "Paper Fig. 1: ring AllReduce cost breakdown (reduce/memcpy vs "
        "simulated EDR wire time) on 8 nodes.",
        grids=(), points=tuple((s,) for s in sizes))


@register
def fig3_sawtooth(quick: bool = False) -> Scenario:
    sizes = (16 * MiB,) if quick else (16 * MiB, 128 * MiB)
    syss = ("haicgu_ce8850", "haicgu_ib", "nanjing_nslb")
    return Scenario(
        "fig3_sawtooth",
        "Paper Fig. 3 / Obs. 1: CE8850 self-congestion sawtooth on 4-node "
        "AllGather; EDR IB and CE9855 stay stable.",
        grids=(), points=tuple((s, v) for s in syss for v in sizes))


@register
def fig4_nslb(quick: bool = False) -> Scenario:
    sizes = (4 * MiB, 16 * MiB) if quick else \
        (MiB, 4 * MiB, 16 * MiB, 64 * MiB)
    return Scenario(
        "fig4_nslb",
        "Paper Fig. 4: NSLB on/off under steady AlltoAll congestion "
        "(4+4 nodes, Nanjing CE9855 leaf-spine).",
        grids=(), points=tuple((m, s) for m in ("nslb", "ecmp")
                               for s in sizes))


def run_fig4_point(mode: str, vector_bytes: float, *, device=None,
                   core=None) -> bench.BenchResult:
    """One Fig. 4 point as the reference's benchmarks/fig4_nslb.py runs it: 4 victim +
    4 aggressor nodes on the Nanjing leaf-spine, steady AlltoAll on
    AlltoAll, NSLB or ECMP static routing."""
    sysp = systems.get_system("nanjing_nslb" if mode == "nslb"
                              else "nanjing_ecmp")
    return bench.run_point(sysp, 8, "alltoall", "alltoall",
                           float(vector_bytes), cong.steady(), n_iters=25,
                           warmup=5, device=device, core=core)
