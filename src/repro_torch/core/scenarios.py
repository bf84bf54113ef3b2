"""Declarative scenario registry: named sweeps over the batched engine.

A :class:`Scenario` is a list of :class:`Grid` specs (each one
``bench.run_grid`` call: one flow set, every size x profile x
baseline/congested cell batched; or, with ``cells``, one scale-batched
``bench.run_scale_grid`` call) or a tuple of ``points`` that a benchmark
script interprets. The port registers the paper's figures: Fig. 1 (ring
AllReduce breakdown), Fig. 3 (self-congestion sawtooth), Fig. 4 (NSLB
on/off), Fig. 5 (steady congestion at scale), Fig. 6 (bursty congestion)
Figs. 7-8 (bursty congestion at larger scale) and §III-B's collective
microbenchmark (``collective_microbench``); and the families
beyond the paper: congestion shapes (``ramp_onset``, ``random_telegraph``,
``multi_tenant``), traffic programs (``phased_collectives``,
``multi_job_mix``), scale-batched sweeps (``scale_sweep``,
``mixed_topology``), faults (``link_fault``, ``intra_node``), the fleet
replay's points (``fleet_replay``) and the mitigation lab's panels
(``mitigation_panel``, ``mitigation_routing``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Tuple

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
    # the §III-B collective microbenchmark's vector sizes (bytes)
    microbench_sizes: Tuple[int, ...] = ()
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


def run_scenario(scenario: Scenario, *, device=None,
                 core=None) -> Iterator[bench.BenchResult]:
    """Run every grid of a scenario, one batched run a grid."""
    for grid in scenario.grids:
        yield from run_grid_spec(scenario, grid, device=device, core=core)


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


@register
def collective_microbench(quick: bool = False) -> Scenario:
    return Scenario(
        "collective_microbench",
        "§III-B: wall-clock cost of the custom collective schedules on 8 "
        "ranks of one process group (benchmarks/pt_collective_bench.py).",
        grids=(), microbench_sizes=(32 * KiB, 2 * MiB))


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
def fleet_replay(quick: bool = False) -> Scenario:
    """Stochastic fleet replay (benchmarks/pt_fleet_replay.py): each point
    is a (system, n_nodes, n_seeds) batched seed sweep through
    core/workload.py with streaming percentile metrics in the state."""
    n_seeds = 8 if quick else 256
    cells = (("cresco8", 16), ("lumi", 16)) if quick \
        else (("cresco8", 32), ("lumi", 32))
    return Scenario(
        "fleet_replay",
        "Fleet-scale stochastic workload replay: Poisson short flows + "
        "training tenants with per-tenant CC mixes, p50/p99/p99.9 queue "
        "delay and FCT from streaming in-scan histograms.",
        grids=(), points=tuple((s, n, n_seeds) for s, n in cells))


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


def run_fig4_points(points, *, device=None,
                    core=None) -> List[bench.BenchResult]:
    """Fig. 4's ``(mode, vector_bytes)`` points as the reference's
    benchmarks/fig4_nslb.py runs each: 4 victim + 4 aggressor nodes on the
    Nanjing leaf-spine, steady AlltoAll on AlltoAll, NSLB or ECMP static
    routing. All of them run as one scale-batched run (the two routings'
    geometries in one bucket, each point's baseline and congested cell);
    a padded cell runs as it runs alone. Results in input order."""
    modes, sizes, grid = fig4_grid(points)
    results = bench.run_scale_grid(*grid, n_iters=25, warmup=5,
                                   device=device, core=core)
    by = {(m, v): r for m in modes for v, r in zip(
        sizes, results[modes.index(m) * len(sizes):])}
    return [by[(m, float(v))] for m, v in points]


def fig4_grid(points) -> tuple:
    """The scale grid :func:`run_fig4_points` runs for ``points``:
    ``(modes, sizes, grid)``, ``grid`` the positional arguments of
    bench.run_scale_grid / bench.scale_grid_inputs (one Nanjing cell a
    routing, cells in the order of ``modes``)."""
    modes = sorted({m for m, _ in points}, key=["nslb", "ecmp"].index)
    sizes = sorted({float(v) for _, v in points})
    cells = [("nanjing_nslb" if m == "nslb" else "nanjing_ecmp", 8)
             for m in modes]
    return modes, sizes, (cells, "alltoall", "alltoall", sizes,
                          (cong.steady(),))


# --------------------------------------------------------------------------
# Beyond-paper congestion shapes
# --------------------------------------------------------------------------


@register
def ramp_onset(quick: bool = False) -> Scenario:
    """Congestion onset: aggressors ramp from idle to full blast, probing
    how fast each fabric's CC walks victims down as pressure builds."""
    ramps = (cong.ramp(1e-3), cong.ramp(8e-3), cong.ramp(32e-3),
             cong.steady())
    sysnames = ("leonardo", "lumi") if quick else FIG5_SYSTEMS
    sizes = (2 * MiB,) if quick else (32 * KiB, 2 * MiB)
    grids = tuple(Grid(s, 32, a, sizes, ramps)
                  for s in sysnames for a in ("incast",))
    return Scenario(
        "ramp_onset",
        "Aggressor intensity ramps 0 -> 1 over 1/8/32 ms (vs steady): "
        "congestion-onset response per fabric.",
        grids)


@register
def random_telegraph(quick: bool = False) -> Scenario:
    """Irregular bursts with the same mean duty cycle as Fig. 6's periodic
    ones: periodic vs random arrival of congestion."""
    pairs = ((2.0, 0.2), (2.0, 8.0)) if quick else \
        ((0.5, 0.2), (2.0, 0.2), (2.0, 8.0), (8.0, 8.0))
    profiles = []
    for b, p in pairs:
        profiles.append(cong.bursty(b * 1e-3, p * 1e-3))
        profiles.append(cong.random_onoff(b * 1e-3, p * 1e-3, seed=1))
    sysnames = ("cresco8", "leonardo") if quick else FIG5_SYSTEMS
    grids = tuple(Grid(s, 32, "incast", (2 * MiB,), tuple(profiles))
                  for s in sysnames)
    return Scenario(
        "random_telegraph",
        "Periodic vs random on/off aggressors at matched duty cycles.",
        grids)


@register
def multi_tenant(quick: bool = False) -> Scenario:
    """Several aggressor tenants with different burst periods share the
    aggressor nodes; their envelopes blend into a fractional intensity
    whose duty cycle matches a single mid-period tenant."""
    tenants = cong.multi_tenant(
        (cong.bursty(0.5e-3, 0.5e-3), 1 / 3),
        (cong.bursty(2e-3, 2e-3), 1 / 3),
        (cong.random_onoff(4e-3, 4e-3, seed=3), 1 / 3))
    profiles = (tenants, cong.bursty(2e-3, 2e-3), cong.steady())
    sysnames = ("leonardo", "lumi") if quick else FIG5_SYSTEMS
    grids = tuple(Grid(s, 32, a, (2 * MiB,), profiles)
                  for s in sysnames for a in ("alltoall", "incast"))
    return Scenario(
        "multi_tenant",
        "Three desynchronized tenant envelopes blended at 1/3 weight each "
        "vs a single 50%-duty tenant vs steady.",
        grids)


# --------------------------------------------------------------------------
# Traffic-program families (phased schedules, multi-job mixes)
# --------------------------------------------------------------------------


@register
def phased_collectives(quick: bool = False) -> Scenario:
    """Phased vs flattened lowering of the same victim under the same
    aggressor; the paired grids share (system, victim, aggressor, sizes),
    so the ratio delta isolates the schedule."""
    sysnames = ("leonardo", "cresco8") if quick else FIG5_SYSTEMS
    victims = ("alltoall",) if quick else ("ring_allreduce", "alltoall")
    sizes = (2 * MiB,) if quick else (32 * KiB, 2 * MiB)
    profiles = (cong.steady(),) if quick else \
        (cong.steady(), cong.bursty(2e-3, 2e-3))
    grids = []
    for s in sysnames:
        for a in FIG5_AGGRESSORS:
            for v in victims:
                for ph in (False, True):
                    grids.append(Grid(s, 32, a, sizes, profiles,
                                      victim=v, phased=ph))
    return Scenario(
        "phased_collectives",
        "Phased (barrier-gated step schedules) vs flattened victim "
        "lowerings under steady/bursty aggressors.",
        tuple(grids), n_iters=15, warmup=3)


def _mix_jobs(kind: str) -> Tuple[JobSpec, ...]:
    """Canned programs of two or more jobs. Job 0 is the measured
    primary; background jobs are envelope-gated, so the per-size baseline
    cell (envelope off) isolates the primary job on the same
    allocation."""
    if kind == "training_vs_training":
        return (JobSpec("train_a", "ring_allreduce", phased=True),
                JobSpec("train_b", "ring_allreduce", vector_bytes=2 * MiB,
                        phased=True, envelope_gated=True,
                        sweep_bytes=False))
    if kind == "training_vs_incast":
        return (JobSpec("train", "ring_allreduce", phased=True),
                JobSpec("incast_job", "incast", endless=True,
                        envelope_gated=True, sweep_bytes=False))
    if kind == "four_tenant":
        return (JobSpec("tenant0", "ring_allreduce", phased=True),) + tuple(
            JobSpec(f"tenant{i}", "ring_allreduce", vector_bytes=2 * MiB,
                    phased=True, envelope_gated=True, sweep_bytes=False)
            for i in range(1, 4))
    raise KeyError(kind)


@register
def multi_job_mix(quick: bool = False) -> Scenario:
    """Concurrent-job interference: a phased training job measured
    against a second training tenant, an endless incast tenant and a
    4-tenant fair share, per-job iteration times in ``job_times``."""
    sysnames = ("leonardo",) if quick else ("leonardo", "lumi", "cresco8")
    mixes = ("training_vs_training", "training_vs_incast") if quick else \
        ("training_vs_training", "training_vs_incast", "four_tenant")
    sizes = (2 * MiB,) if quick else (32 * KiB, 2 * MiB)
    profiles = (cong.steady(),) if quick else \
        (cong.steady(), cong.bursty(2e-3, 2e-3))
    grids = tuple(Grid(s, 32, mix, sizes, profiles,
                       victim="ring_allreduce", jobs=_mix_jobs(mix))
                  for s in sysnames for mix in mixes)
    return Scenario(
        "multi_job_mix",
        "Multi-job fabric sharing: training-vs-training, training-vs-"
        "incast, and N-tenant fair-share mixes (job 0 measured; "
        "background tenants envelope-gated).",
        grids, n_iters=12, warmup=3)


# --------------------------------------------------------------------------
# Scale-batched families (heterogeneous topologies in one batch)
# --------------------------------------------------------------------------


@register
def scale_sweep(quick: bool = False) -> Scenario:
    """How congestion impact changes with system size, one scale-batched
    run per aggressor: an EDR/HDR/NDR/Slingshot x {16..512}-node ladder
    of (system, n_nodes) cells padded into one bucket."""
    if quick:
        cells = tuple((s, n) for s in ("cresco8", "lumi")
                      for n in (16, 64))
        sizes: Tuple[float, ...] = (2 * MiB,)
        profiles: Tuple[Profile, ...] = (cong.steady(),)
        aggrs = ("alltoall",)
    else:
        cells = tuple((s, n)
                      for s in ("haicgu_ib", "leonardo", "cresco8", "lumi")
                      for n in (16, 32, 64, 128, 256, 512))
        sizes = (32 * KiB, 2 * MiB)
        profiles = (cong.steady(), cong.bursty(2e-3, 2e-3))
        aggrs = FIG5_AGGRESSORS
    grids = tuple(Grid("scale", 0, a, sizes, profiles, cells=cells)
                  for a in aggrs)
    return Scenario(
        "scale_sweep",
        "Cross-scale congestion: EDR/HDR/NDR/Slingshot x 16..512 nodes "
        "per aggressor, scale-batched (one compile per geometry bucket).",
        grids, n_iters=15, warmup=3)


@register
def mixed_topology(quick: bool = False) -> Scenario:
    """Topology families at matched allocation size (single switch,
    leaf-spine, blocking fat-tree, Dragonfly, Dragonfly+) in one
    scale-batched run: the ratio spread isolates what the fabric's
    structure contributes under the same victim/aggressor program."""
    n = 16 if quick else 32
    names = ("haicgu_ib", "cresco8", "lumi") if quick else \
        ("haicgu_ib", "nanjing_nslb", "cresco8", "lumi", "leonardo")
    cells = tuple((s, n) for s in names)
    sizes = (2 * MiB,) if quick else (32 * KiB, 2 * MiB)
    profiles = (cong.steady(),) if quick else \
        (cong.steady(), cong.bursty(2e-3, 2e-3))
    aggrs = ("incast",) if quick else FIG5_AGGRESSORS
    grids = tuple(Grid("mixed", 0, a, sizes, profiles, cells=cells)
                  for a in aggrs)
    return Scenario(
        "mixed_topology",
        "Heterogeneous topology families (single-switch / leaf-spine / "
        "fat-tree / dragonfly / dragonfly+) at one scale, batched into "
        "geometry buckets.",
        grids, n_iters=15, warmup=3)


# --------------------------------------------------------------------------
# Mitigation-lab families (mitigation/search + score;
# benchmarks/pt_mitigation_lab.py scores candidates across these)
# --------------------------------------------------------------------------


@register
def mitigation_panel(quick: bool = False) -> Scenario:
    """The mitigation lab's scoring panel: every candidate (CC config x
    routing policy) is measured on each of these cells (score.py turns
    grids into PanelCells). Quick: the Fig. 4 leaf-spine cell (the
    load-balancing axis) and the bursty Leonardo incast collapse (the CC
    axis); full adds the steady incast collapse, a multi-job mix and a
    flapping hot link under live incast."""
    grids = [
        Grid("nanjing_nslb", 8, "alltoall", (4 * MiB,), (cong.steady(),),
             victim="alltoall"),
        Grid("leonardo", 64, "incast", (2 * MiB,),
             (cong.bursty(2e-3, 2e-3),)),
    ]
    if not quick:
        grids += [
            Grid("leonardo", 32, "incast", (2 * MiB,), (cong.steady(),)),
            Grid("leonardo", 32, "training_vs_incast", (2 * MiB,),
                 (cong.steady(),), victim="ring_allreduce",
                 jobs=_mix_jobs("training_vs_incast")),
            Grid("leonardo", 32, "incast", (2 * MiB,),
                 (cong.with_faults(cong.steady(),
                                   cong.flap(0.2e-3, 20e-3, duty=0.3,
                                             seed=5)),)),
        ]
    return Scenario(
        "mitigation_panel",
        "Mitigation-lab scoring panel: steady Fig.4 leaf-spine, bursty "
        "and steady Leonardo incast collapse, multi-job mix.",
        tuple(grids), n_iters=12, warmup=3)


@register
def mitigation_routing(quick: bool = False) -> Scenario:
    """Routing-policy shootout on path-diverse fabrics (fixed / ECMP /
    NSLB / adaptive / flowlet are per-cell data); as a plain scenario it
    runs the mixed-routing scale-batched path end to end."""
    cells = (("nanjing_ecmp", 8), ("cresco8", 16)) if quick else \
        (("nanjing_ecmp", 8), ("nanjing_nslb", 8), ("cresco8", 16),
         ("leonardo", 32))
    sizes = (4 * MiB,) if quick else (512 * KiB, 4 * MiB)
    profiles = (cong.steady(),) if quick else \
        (cong.steady(), cong.bursty(2e-3, 2e-3))
    grids = tuple(Grid("mitigation", 0, a, sizes, profiles,
                       victim="alltoall", cells=cells)
                  for a in (("alltoall",) if quick
                            else ("alltoall", "incast")))
    return Scenario(
        "mitigation_routing",
        "Mixed-routing shootout (leaf-spine ECMP/NSLB, fat-tree and "
        "Dragonfly+ AR) — one scale-batched compile across routing "
        "modes.",
        grids, n_iters=12, warmup=3)


# --------------------------------------------------------------------------
# Fault families (link faults, the intra-node stage)
# --------------------------------------------------------------------------


@register
def link_fault(quick: bool = False) -> Scenario:
    """Link failures and degradation as time-varying per-link capacity:
    a flapping hot link, a dying optic (a linear decay that persists),
    fabric-wide jitter, a hard outage and a switch outage, each on an
    otherwise clean fabric, plus a flap under live incast congestion.
    Scale-batched."""
    hot_flap = cong.with_faults(
        cong.no_congestion(), cong.flap(0.2e-3, 20e-3, duty=0.3, seed=5))
    dying_optic = cong.with_faults(
        cong.no_congestion(), cong.degrade(0.2e-3, 1.5e-3, severity=0.7))
    fabric_jitter = cong.with_faults(
        cong.no_congestion(),
        cong.jitter(0.2e-3, 20e-3, severity=0.6,
                    link_group=cong.GROUP_FABRIC, seed=9))
    flap_under_incast = cong.with_faults(
        cong.steady(), cong.flap(0.2e-3, 20e-3, duty=0.3, seed=5))
    if quick:
        cells = (("leonardo", 16), ("lumi", 16))
        clean_profiles = (hot_flap, dying_optic)
        sizes: Tuple[float, ...] = (2 * MiB,)
    else:
        cells = (("leonardo", 16), ("leonardo", 64), ("lumi", 16),
                 ("lumi", 64), ("cresco8", 16))
        clean_profiles = (hot_flap, dying_optic, fabric_jitter,
                          cong.with_faults(
                              cong.no_congestion(),
                              cong.outage(0.5e-3, 2e-3, severity=1.0)),
                          cong.with_faults(
                              cong.no_congestion(),
                              cong.switch_outage(0.5e-3, 2e-3,
                                                 severity=0.9)))
        sizes = (256 * KiB, 2 * MiB)
    grids = (
        # no aggressor: every flow is the victim's, so GROUP_HOT is the
        # victim's own most-traversed link
        Grid("fault", 0, "", sizes, clean_profiles, cells=cells),
        # the hot link flaps while incast runs
        Grid("fault", 0, "incast", sizes, (flap_under_incast,),
             cells=cells[:2] if quick else cells),
    )
    return Scenario(
        "link_fault",
        "Flapping hot link, dying optic, fabric jitter and hard outage "
        "as per-link capacity envelopes, alone and compounding incast.",
        grids, n_iters=12, warmup=3)


@register
def intra_node(quick: bool = False) -> Scenario:
    """Intra-node (NVLink/PCIe) contention: a proportional-share stage
    ahead of the NIC, swept over the node-capacity fraction. AlltoAll
    victims put many concurrent flows on each node, so the stage becomes
    the bottleneck as the fraction drops."""
    fracs = (1.0, 0.5, 0.25) if quick else (2.0, 1.0, 0.5, 0.25)
    profiles = tuple(cong.with_node_cap(cong.no_congestion(), f)
                     for f in fracs)
    cells = (("leonardo", 16), ("lumi", 16)) if quick else \
        (("leonardo", 16), ("leonardo", 32), ("lumi", 16), ("lumi", 32),
         ("cresco8", 16))
    sizes = (1 * MiB,) if quick else (256 * KiB, 1 * MiB)
    grids = (Grid("intra", 0, "", sizes, profiles, victim="alltoall",
                  cells=cells),)
    return Scenario(
        "intra_node",
        "Intra-node (NVLink/PCIe) stage contention: AlltoAll victims vs "
        "a swept per-node capacity fraction ahead of the NIC.",
        grids, n_iters=12, warmup=3)
