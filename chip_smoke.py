#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Builds the port's two CUDA kernels from ``src/repro_torch/csrc`` (into
``build/`` on first use, both nvcc runs started together), then:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the fabric-step and fused-accumulate kernels and reports the
   build time;
3. holds the fabric-step kernel against its plain PyTorch version on the
   card at the characterization grids' shapes, at the shapes and batch
   sizes each figure path gives it (Fig. 1's 8-node ring AllReduce, Fig.
   3's three 4-node single cells, Fig. 6's six quick grids and its 2 MiB
   burst x pause grid) and on random shapes, with and without the aux
   observer (DESIGN.md §13 tolerance, bit-exact where every segment has
   one contributor) and checks two launches agree bitwise;
4. holds the fused-accumulate kernel bit-equal to its plain version at
   the fig1 tiles and (300, 640), in four type pairs and two scales, with
   acc unaligned, and in the bfloat16 256 + 1 case;
5. runs 50 lock-step engine steps with the kernel and with the plain
   version on leonardo/64/incast and cresco8/256/alltoall;
6. drives the main path: the fig4_nslb quick points and four fig5_steady
   quick grids through ``repro_torch.core.scenarios`` on the card, held to
   ``artifacts/bench_cache_torch/jax_reference.json`` (equal iteration
   counts, times within 2%) and to the paper's behaviour pins, and checks
   that every engine step launched the kernel once;
7. drives the figure runner's paths, each with the launch counts reset
   before it and read after it: Fig. 1 at its three sizes through
   ``benchmarks/pt_fig1_breakdown.run_size`` (network time, iteration
   counts and wire bytes against JAX; kernel 2 launched), Fig. 3's six
   goodput traces through ``benchmarks/pt_fig3_sawtooth.run_point``
   (trace length, goodput and CV against JAX; the Obs. 1 pin) and Fig. 6's
   six quick grids plus the leonardo/64/incast 2 MiB burst x pause grid
   (iteration counts and times against JAX; the Obs. 3 pin);
8. times both kernels, their plain versions, their bounds and, for the
   fused accumulate, the library call ``torch.add``, per shape.

It prints a ``{"kernels": [...]}`` line before the last and ends with
``{"ok": true, "device": {...}}``; any failed check exits non-zero
without that line. Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                         "jax_reference.json")
REPORT = os.path.join(ROOT, "chiprun_out", "chip_smoke.json")

# H100 SXM published peaks (NVIDIA data sheet) for the bound column
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
FS_TOL = dict(rtol=2e-4, atol=1.0)  # DESIGN.md §13
TIME_RTOL = 0.02
# lock-step leaves held tighter than §13's atol: times in seconds, and
# integers and flags held exactly
SECONDS_LEAVES = ("t", "idle", "last_dec", "gap", "t_done", "qdel")
INT_LEAVES = ("rc", "ph", "it", "active", "advance", "wrap", "done")
KERNEL = {"name": "fabric_step_core", "route": "cuda",
          "source": "src/repro_torch/csrc/fabric_step.cu",
          "replaces": "src/repro/kernels/fabric_step.py:175"}
KERNEL2 = {"name": "fused_accumulate", "route": "cuda",
           "source": "src/repro_torch/csrc/fused_reduce.cu",
           "replaces": "src/repro/kernels/fused_reduce.py:27"}
# kernel 2's float32 tiles on the fig1 path (1, 16 and 128 MiB), the
# reference's edge-tile test shape, and the tile the kernels line reports
FIG1_TILES = ((64, 512), (1024, 512), (8192, 512))
EDGE_TILE = (300, 640)
MAIN_TILE = (8192, 512)
# (acc, x) type pairs and scales kernel 2 is checked at
FR_TYPES = (("float32", "float32"), ("bfloat16", "bfloat16"),
            ("float32", "bfloat16"), ("bfloat16", "float32"))
FR_SCALES = (1.0, 0.25)
# Fig. 3 CV against JAX: within CV_ATOL + CV_RTOL * |cv|. The port has
# agreed to 1.5e-8; a wrong run moves nanjing_nslb's CV, the Obs. 1 pin's
# denominator, by far more (PERF.md §6)
CV_RTOL, CV_ATOL = 1e-3, 1e-5
# Obs. 3 in the 2 MiB burst x pause grid: short bursts hurt less; the
# longest bursts approach steady congestion (fig5 leonardo/64/incast)
OBS3_SHORT_BURST_MS, OBS3_SHORT_MIN = 0.5, 0.9
OBS3_LONG_BURST_MS = 8.0
# fig5_steady quick grids on the main path: (system, n_nodes, aggressor)
FIG5_GRIDS = (("leonardo", 64, "incast"), ("leonardo", 256, "incast"),
              ("lumi", 256, "incast"), ("cresco8", 256, "incast"))
# (label, system, n_nodes, victim, aggressor) of the kernel's slice shapes
SLICE_SHAPES = (("nanjing_ecmp/8/alltoall", "nanjing_ecmp", 8, "alltoall",
                 "alltoall"),
                ("leonardo/64/incast", "leonardo", 64, "ring_allgather",
                 "incast"),
                ("leonardo/256/incast", "leonardo", 256, "ring_allgather",
                 "incast"),
                ("lumi/256/incast", "lumi", 256, "ring_allgather", "incast"),
                ("cresco8/256/alltoall", "cresco8", 256, "ring_allgather",
                 "alltoall"))
MAIN_SHAPE = "leonardo/256/incast"  # the main path's longest grid
# (F, H, L, n_src, n_sw) random shapes, as the reference's kernel tests
RANDOM_SHAPES = ((7, 3, 13, 4, 5), (130, 5, 300, 33, 17),
                 (256, 4, 255, 8, 8), (1, 1, 2, 1, 2))


def log(*a):
    print(*a, flush=True)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = "cuda"
        self.failures = []
        self.report = {"phases": {}}

    def check(self, ok: bool, what: str):
        if not ok:
            self.failures.append(what)
            log(f"FAIL: {what}")

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.time()
        try:
            fn()
        except Exception:  # a failed phase fails the run, after the rest
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"FAIL: phase {name}\n{traceback.format_exc()}")
        self.report["phases"][name] = round(time.time() - t0, 3)
        log(f"   {name}: {time.time() - t0:.1f}s")

    # ---------------------------------------------------------------- 1
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        self.smi = smi.stdout.strip().splitlines()[0] if smi.stdout \
            else "nvidia-smi: unavailable"
        log(self.smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)} "
            f"count {torch.cuda.device_count()}")
        self.report["card"] = self.smi

    # ---------------------------------------------------------------- 2
    def build(self):
        from concurrent.futures import ThreadPoolExecutor
        from repro_torch.kernels import _build
        from repro_torch.kernels import fabric_step as fs
        from repro_torch.kernels import fused_reduce as fr
        t0 = time.time()
        with ThreadPoolExecutor(2) as pool:  # one nvcc per source
            libs = list(pool.map(lambda k: _build.build(k.SOURCE),
                                 (fs, fr)))
        fs._load()
        fr._load()
        self.report["build_s"] = time.time() - t0
        for k, lib in zip((fs, fr), libs):
            log(f"built {os.path.relpath(lib, ROOT)}")
            for line in _build.log(k.SOURCE).splitlines():
                if "registers" in line or "smem" in line or "spill" in line:
                    log("   ptxas:", line.strip())
        log(f"   both built in {time.time() - t0:.1f}s")

    # ------------------------------------------------------------ inputs
    def grid_case(self, system, n, victim, aggr, sizes=None, profiles=None):
        """A grid's geometry and stacked params on the card, as run_grid
        builds them (sizes x baseline/profiles; by default the fig5 sizes
        and the steady profile)."""
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import simulator as sim, systems
        case = bench.build_case(systems.get_system(system), n, victim, aggr)
        if sizes is None:
            sizes = (4 << 20, 16 << 20) if system.startswith("nanjing") \
                else (32 << 10, 2 << 20)
        if profiles is None:
            profiles = (cong.steady(),)
        dts = bench._cell_dts(case, sizes, len(profiles), None, case.lat())
        cells = [(float(v), pr) for v in sizes
                 for pr in [cong.no_congestion(), *profiles]]
        params = sim.stack_params([case.cell_params(v, pr, d) for (v, pr), d
                                   in zip(cells, dts)])
        return case, case.geom.to(self.dev), params.to(self.dev)

    def path_cases(self):
        """(label, geometry, stacked params) on the card of every figure
        path's kernel-1 inputs, as its driver builds them: Fig. 1's run_point
        (baseline + uncongested, B=2), Fig. 3's goodput_trace per system
        (B=1), Fig. 6's quick grids (B=5) and its 2 MiB burst x pause grid
        (B=10)."""
        from benchmarks import pt_fig1_breakdown as fig1
        from benchmarks import pt_fig3_sawtooth as fig3
        from benchmarks import pt_fig6_bursty as fig6
        from repro_torch.core import bench, congestion as cong, scenarios
        from repro_torch.core.fabric import simulator as sim, systems
        _, geom, p = self.grid_case("haicgu_ib", fig1.N_NODES,
                                    "ring_allreduce", "", (16 << 20,),
                                    (cong.no_congestion(),))
        yield f"fig1 haicgu_ib/{fig1.N_NODES}/ring_allreduce", geom, p
        for system in fig3.SYSTEMS:
            geom, p = bench.goodput_case(systems.get_system(system),
                                         fig3.N_NODES, fig3.COLLECTIVE,
                                         16 << 20)
            yield (f"fig3 {system}/{fig3.N_NODES}/{fig3.COLLECTIVE}",
                   geom.to(self.dev), sim.stack_params([p]).to(self.dev))
        grids = scenarios.get("fig6_bursty", True).grids + (
            fig6.grid_at_size("leonardo", "incast", 2 << 20),)
        for g in grids:
            _, geom, p = self.grid_case(g.system, g.n_nodes, g.victim,
                                        g.aggressor, g.sizes, g.profiles)
            yield (f"fig6 {g.system}/{g.n_nodes}/{g.aggressor} "
                   f"{g.sizes[0]:.0f}", geom, p)

    def core_inputs(self, geom, p, seed):
        """Step-core operands at a grid's shapes: each flow on one of its
        candidate paths, rates up to its NIC cap, queues up to qmax."""
        torch = self.torch
        import numpy as np
        rng = np.random.RandomState(seed)
        B = p.dt.shape[0]
        F = geom.n_flows
        n_paths = geom.n_paths.cpu().numpy()
        choice = (rng.rand(B, F) * n_paths).astype(np.int64)
        plinks = geom.paths[geom.flow_ar, torch.as_tensor(
            choice, device=self.dev)].contiguous()
        inject = (p.host_caps * torch.as_tensor(
            rng.rand(B, F), dtype=torch.float32, device=self.dev)).contiguous()
        q = torch.as_tensor(rng.rand(B, geom.L + 1), dtype=torch.float32,
                            device=self.dev) * p.qmax_bytes[:, None] * 0.9
        q[:, -1] = 0.0
        occ = q / p.qmax_bytes[:, None]
        return (plinks, inject, geom.src_id, p.host_caps, q, occ,
                geom.caps_finite, geom.src_sw, geom.dst_sw, p.dt,
                p.qmax_bytes, p.hol_factor, p.hol_start, p.burst_jitter), \
            dict(n_src=geom.n_src, n_sw=geom.n_sw)

    def random_inputs(self, shape, seed, B=2):
        torch = self.torch
        import numpy as np
        F, H, L, n_src, n_sw = shape
        rng = np.random.RandomState(seed)
        t = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
            x, dtype=dt, device=self.dev).contiguous()
        q = rng.rand(B, L + 1) * 1e6
        sc = [t(rng.uniform(lo, hi, B)) for lo, hi in
              ((1e-6, 4e-6), (2e6, 2e6), (0.0, 0.9), (0.5, 0.8), (0, 0.1))]
        args = (t(rng.randint(0, L + 1, (B, F, H)), torch.int32),
                t(rng.rand(B, F) * 1e9), t(rng.randint(0, n_src, F),
                                           torch.int32),
                t((rng.rand(B, F) + 0.5) * 1e9), t(q), t(q / 2e6),
                t((rng.rand(L + 1) + 0.1) * 1e9),
                t(rng.randint(0, n_sw, L + 1), torch.int32),
                t(rng.randint(0, n_sw, L + 1), torch.int32), *sc)
        return args, dict(n_src=n_src, n_sw=n_sw)

    def zero_capacity(self, args, n_zero=3, silent=2):
        """The same operands with the first ``n_zero`` links at zero
        capacity and the first ``silent`` flows sending nothing: an
        unloaded zero-capacity link divides 0 by 0, and the flows that
        cross it carry the NaN on, in the kernel as in the plain version."""
        args = list(args)
        args[6] = args[6].clone()
        args[6][..., :n_zero] = 0.0
        args[1] = args[1].clone()
        args[1][..., :silent] = 0.0
        return tuple(args)

    def disjoint_inputs(self):
        """At most one contributor per (link, hop), source and switch."""
        torch = self.torch
        import numpy as np
        F, H = 6, 3
        L = F * H + 4
        args, kw = self.random_inputs((F, H, L, F + 1, L + 2), 0, B=1)
        args = list(args)
        args[0] = torch.arange(F * H, dtype=torch.int32,
                               device=self.dev).view(1, F, H)
        args[2] = torch.arange(F, dtype=torch.int32, device=self.dev)
        args[7] = torch.arange(1, L + 2, dtype=torch.int32, device=self.dev)
        args[8] = torch.as_tensor(np.roll(np.arange(1, L + 2), 1),
                                  dtype=torch.int32, device=self.dev)
        return tuple(args), kw

    # ---------------------------------------------------------------- 3
    def compare(self, label, args, kw, with_aux, exact=False):
        """Kernel vs plain on the same card tensors; returns max abs err."""
        torch = self.torch
        from repro_torch.kernels import fabric_step as fs, ref
        k1 = fs.fabric_step_core(*args, with_aux=with_aux, **kw)
        k2 = fs.fabric_step_core(*args, with_aux=with_aux, **kw)
        pl = ref.fabric_step_core(*args, with_aux=with_aux, **kw)
        torch.cuda.synchronize()
        worst, parts = 0.0, []
        for k, want in pl.items():
            if want is None:
                continue
            got = k1[k]
            # NaN where, and only where, the plain version has NaN
            nan = torch.isnan(want)
            self.check(bool(torch.equal(torch.isnan(got), nan)),
                       f"{label}: {k} NaN pattern differs")
            got, want = got[~nan], want[~nan]
            err = (got - want).abs()
            tol = FS_TOL["atol"] + FS_TOL["rtol"] * want.abs()
            mabs = float(err.max()) if err.numel() else 0.0
            mrel = float((err / want.abs().clamp_min(1e-30)).max()) \
                if err.numel() else 0.0
            worst = max(worst, mabs)
            parts.append(f"{k} {mabs:.3g}/{mrel:.3g}"
                         + (f" ({int(nan.sum())} NaN)" if nan.any() else ""))
            if exact:
                self.check(bool(torch.equal(got, want)),
                           f"{label}: {k} not bit-exact")
            self.check(bool((err <= tol).all()) and bool(
                torch.isfinite(got).all()),
                f"{label}: {k} beyond §13 (max abs {mabs}, rel {mrel})")
        same = all(torch.equal(k1[k].nan_to_num(), k2[k].nan_to_num())
                   for k in k1 if k1[k] is not None)
        log(f"   {label:32s} aux={int(with_aux)} max abs/rel err: "
            f"{', '.join(parts)}; two launches bitwise equal: {same}")
        return worst

    def kernel_vs_plain(self):
        self.shapes = {}
        for i, (label, system, n, victim, aggr) in enumerate(SLICE_SHAPES):
            case, geom, p = self.grid_case(system, n, victim, aggr)
            args, kw = self.core_inputs(geom, p, seed=100 + i)
            B, F, H = args[0].shape
            self.shapes[label] = (args, kw)
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} "
                f"n_sw={geom.n_sw} n_src={geom.n_src}")
            for aux in (False, True):
                err = self.compare(label, args, kw, aux)
                if label == MAIN_SHAPE and not aux:
                    self.main_err = err
        for i, (label, geom, p) in enumerate(self.path_cases()):
            args, kw = self.core_inputs(geom, p, seed=200 + i)
            B, F, H = args[0].shape
            log(f"   {label}: B={B} F={F} H={H} L={geom.L} "
                f"n_sw={geom.n_sw} n_src={geom.n_src}")
            for aux in (False, True):
                self.compare(label, args, kw, aux)
        for i, shape in enumerate(RANDOM_SHAPES):
            args, kw = self.random_inputs(shape, seed=i)
            for aux in (False, True):
                self.compare(f"random {shape}", args, kw, aux)
        args, kw = self.disjoint_inputs()
        self.compare("disjoint (bit-exact)", args, kw, True, exact=True)
        self.compare("disjoint, zero-capacity links (bit-exact)",
                     self.zero_capacity(args), kw, True, exact=True)
        args, kw = self.random_inputs(RANDOM_SHAPES[1], seed=9)
        self.compare(f"random {RANDOM_SHAPES[1]}, zero-capacity links",
                     self.zero_capacity(args, n_zero=30, silent=40), kw, True)

    # ------------------------------------------------------------- 4
    def fr_inputs(self, shape, acc_t, x_t, seed, offset=0):
        """Normal values at ``shape`` in the two types, on the card;
        ``offset`` > 0 starts acc that many elements into its storage, so
        the kernel takes its unaligned scalar loop."""
        torch = self.torch
        import numpy as np
        rng = np.random.RandomState(seed)
        n = shape[0] * shape[1]
        a = torch.as_tensor(rng.standard_normal(n + offset) * 8,
                            dtype=torch.float32, device=self.dev)
        x = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                            device=self.dev)
        acc = a.to(getattr(torch, acc_t))[offset:].view(shape)
        return acc, x.to(getattr(torch, x_t)).view(shape)

    def fr_compare(self, label, acc, x, scale):
        """Kernel 2 vs plain on the same card tensors, held bit-equal: both
        round the product, then the sum, then the cast. Returns the max
        abs err."""
        torch = self.torch
        from repro_torch.kernels import fused_reduce as fr, ref
        got = fr.fused_accumulate(acc, x, scale)
        want = ref.fused_accumulate(acc, x, scale)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            self.check(False, f"{label}: dtype/shape {got.dtype} "
                       f"{tuple(got.shape)}, plain {want.dtype} "
                       f"{tuple(want.shape)}")
            return float("inf")
        mabs = float((got.float() - want.float()).abs().max())
        self.check(bool(torch.equal(got, want)),
                   f"{label}: not bit-equal, max abs err {mabs}")
        return mabs

    def fr_vs_plain(self):
        torch = self.torch
        n = 0
        self.fr_main_err = 0.0
        for shape in FIG1_TILES + (EDGE_TILE,):
            for acc_t, x_t in FR_TYPES:
                for scale in FR_SCALES:
                    acc, x = self.fr_inputs(shape, acc_t, x_t, seed=n)
                    err = self.fr_compare(f"{shape} {acc_t}/{x_t} x{scale}",
                                          acc, x, scale)
                    if shape == MAIN_TILE and acc_t == x_t == "float32":
                        self.fr_main_err = max(self.fr_main_err, err)
                    n += 1
        for acc_t, x_t in FR_TYPES:  # unaligned acc: the scalar loop
            acc, x = self.fr_inputs(EDGE_TILE, acc_t, x_t, seed=n, offset=1)
            self.fr_compare(f"{EDGE_TILE} {acc_t}/{x_t} unaligned", acc, x,
                            0.25)
            n += 1
        acc = torch.full((8, 128), 256.0, dtype=torch.bfloat16,
                         device=self.dev)
        one = torch.ones_like(acc)
        self.fr_compare("bf16 256 + 1", acc, one, 1.0)
        log(f"   {n + 1} cases held bit-equal")
        self.report["fused_accumulate_cases"] = n + 1

    # ---------------------------------------------------------------- 5
    def lockstep(self):
        torch = self.torch
        from repro_torch.core.fabric import simulator as sim
        for system, n, aggr in (("leonardo", 64, "incast"),
                                ("cresco8", 256, "alltoall")):
            _, geom, p = self.grid_case(system, n, "ring_allgather", aggr)
            state = sim.init_state(geom, p)
            worst = 0.0
            for i in range(50):
                sk, gk, ak = sim.step_debug(geom, p, state, core="kernel")
                sp, gp, ap = sim.step_debug(geom, p, state, core="plain")
                pairs = [(f"state {k}", sk[k], sp[k]) for k in sp] + \
                    [(f"aux {k}", ak[k], ap[k]) for k in ap] + \
                    [("goodput", gk, gp)]
                for what, got, want in pairs:
                    atol, rtol = leaf_tol(what.split()[-1], p.dt, want.dim())
                    got, want = got.double(), want.double()
                    err = (got - want).abs()
                    excess = err - atol - rtol * want.abs()
                    worst = max(worst, float(excess.max()))
                    self.check(bool((excess <= 0).all()),
                               f"lockstep {system}/{n}/{aggr} step {i} "
                               f"{what}: max abs err {float(err.max())}")
                state = sp
            torch.cuda.synchronize()
            log(f"   {system}/{n}/{aggr}: F={geom.n_flows} 50 steps kernel "
                f"vs plain, worst error less tolerance {worst:.3g} "
                f"(<= 0 passes), it {state['it'][:, 0].tolist()}")

    # ---------------------------------------------------------------- 6
    def main_path(self):
        torch = self.torch
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs, fused_reduce as fr
        ref = self.reference()
        log(f"   reference: jax {ref['jax_version']} "
            f"({ref['jax_backend']}) commit {ref['commit'][:12]}")
        rows = []
        fs.launches = fr.launches = sim.step_count = 0
        t_main = time.time()
        for want in ref["fig4_nslb"]:
            t0, s0 = time.time(), sim.step_count
            r = scenarios.run_fig4_point(want["mode"], want["vector_bytes"],
                                         device=self.dev)
            torch.cuda.synchronize()
            rows.append(self.hold(f"fig4 {want['mode']} "
                                  f"{want['vector_bytes']:.0f}", r, want,
                                  time.time() - t0, sim.step_count - s0))
        scen = scenarios.get("fig5_steady", True)
        for system, n, aggr in FIG5_GRIDS:
            grid = next(g for g in scen.grids if (g.system, g.n_nodes,
                                                  g.aggressor) == (system, n,
                                                                   aggr))
            t0, s0 = time.time(), sim.step_count
            results = scenarios.run_grid_spec(scen, grid, device=self.dev)
            torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   fig5 {system}/{n}/{aggr}: {steps} steps in {wall:.1f}s "
                f"({steps / wall:.0f} steps/s)")
            for r in results:
                want = next(w for w in ref["fig5_steady"] if
                            (w["system"], w["n_nodes"], w["aggressor"],
                             w["vector_bytes"]) == (system, n, aggr,
                                                    r.vector_bytes))
                rows.append(self.hold(f"fig5 {system}/{n}/{aggr} "
                                      f"{r.vector_bytes:.0f}", r, want,
                                      wall, steps))
        self.main_launches = fs.launches
        self.main_steps = sim.step_count
        log(f"   main path: {sim.step_count} engine steps, "
            f"{fs.launches} kernel launches, "
            f"{time.time() - t_main:.1f}s wall")
        self.report.setdefault("paths", {})["main_path"] = {
            "wall_s": time.time() - t_main, "steps": sim.step_count,
            "launches": {"fabric_step_core": fs.launches,
                         "fused_accumulate": fr.launches}}
        self.check(fs.launches == sim.step_count and fs.launches > 0,
                   f"kernel launches {fs.launches} != engine steps "
                   f"{sim.step_count}")
        by = {row["label"]: row["ratio"] for row in rows}
        for label, ratio in by.items():
            if label.startswith("fig4 nslb"):
                self.check(ratio >= 0.9, f"pin: {label} ratio {ratio} < 0.9")
            if label.startswith("fig4 ecmp"):
                self.check(ratio < 0.85,
                           f"pin: {label} ratio {ratio} >= 0.85")
            if label.startswith("fig5 lumi/256"):
                self.check(ratio >= 0.95,
                           f"pin: {label} ratio {ratio} < 0.95")
        lab = f"fig5 leonardo/256/incast {2 << 20}"
        self.check(by.get(lab, 1.0) < 0.2, f"pin: {lab} ratio "
                   f"{by.get(lab)} >= 0.2")
        self.report["main_path"] = rows

    def hold(self, label, r, want, wall, steps):
        import math
        du = r.t_uncongested_s / want["t_uncongested_s"] - 1
        dc = r.t_congested_s / want["t_congested_s"] - 1
        log(f"   {label}: ratio {r.ratio:.4f} (jax {want['ratio']:.4f}) "
            f"n_iters {r.n_iters} (jax {tuple(want['n_iters'])}) "
            f"dt_u {du:+.2e} dt_c {dc:+.2e}")
        self.check(list(r.n_iters) == list(want["n_iters"]),
                   f"{label}: n_iters {r.n_iters} != {want['n_iters']}")
        self.check(math.isfinite(r.ratio) and not r.dnf,
                   f"{label}: ratio {r.ratio}")
        self.check(abs(du) <= TIME_RTOL and abs(dc) <= TIME_RTOL,
                   f"{label}: times off by {du:+.3%} / {dc:+.3%}")
        return {"label": label, "ratio": r.ratio, "jax_ratio": want["ratio"],
                "n_iters": list(r.n_iters),
                "t_uncongested_s": r.t_uncongested_s,
                "t_congested_s": r.t_congested_s, "rel_err_t_u": du,
                "rel_err_t_c": dc, "grid_wall_s": wall,
                "grid_steps": steps}

    # ---------------------------------------------------------------- 7
    def path(self, name, fn):
        """Drive one path with every launch count set to 0 just before it
        and read just after; each kernel of the path must have launched,
        and kernel 1 once per engine step."""
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs, fused_reduce as fr
        fs.launches = fr.launches = sim.step_count = 0
        t0 = time.time()
        kernels = fn()
        wall = time.time() - t0
        counts = {"fabric_step_core": fs.launches,
                  "fused_accumulate": fr.launches}
        log(f"   {name}: {sim.step_count} engine steps, launches {counts}, "
            f"{wall:.1f}s wall")
        self.check(fs.launches == sim.step_count,
                   f"{name}: kernel 1 launches {fs.launches} != engine "
                   f"steps {sim.step_count}")
        for k in kernels:
            self.check(counts[k] > 0, f"{name}: {k} never launched")
        self.report.setdefault("paths", {})[name] = {
            "wall_s": wall, "steps": sim.step_count, "launches": counts}
        return counts

    def reference(self):
        with open(REFERENCE) as f:
            return json.load(f)

    def fig1(self):
        from benchmarks import pt_fig1_breakdown as fig1
        ref = self.reference()["fig1_breakdown"]
        rows = []

        def run():
            for want in ref:
                v = want["vector_bytes"]
                r = fig1.run_size(v, device=self.dev)
                dn = r["t_network_us"] / (want["t_uncongested_s"] * 1e6) - 1
                log(f"   fig1 {v:.0f}: network {r['t_network_us']:.1f} us "
                    f"(jax {want['t_uncongested_s'] * 1e6:.1f}, {dn:+.2e}) "
                    f"n_iters {r['n_iters']}; reduce "
                    f"{r['t_reduce_us']:.1f} us, memcpy "
                    f"{r['t_memcpy_us']:.1f} us, fused "
                    f"{r['t_fused_reduce_us']:.1f} us, compute fraction "
                    f"{r['compute_fraction']:.4f}")
                self.check(list(r["n_iters"]) == want["n_iters"],
                           f"fig1 {v}: n_iters {r['n_iters']} != "
                           f"{want['n_iters']}")
                self.check(abs(dn) <= TIME_RTOL,
                           f"fig1 {v}: network time off by {dn:+.3%}")
                self.check(r["wire_bytes"] == want["wire_bytes"],
                           f"fig1 {v}: wire bytes {r['wire_bytes']} != "
                           f"{want['wire_bytes']}")
                rows.append({**r, "vector_bytes": v, "rel_err_t_network": dn})
            return ("fabric_step_core", "fused_accumulate")

        self.fr_path_launches = self.path("fig1", run)["fused_accumulate"]
        self.report["fig1"] = rows

    def fig3(self):
        from benchmarks import pt_fig3_sawtooth as fig3
        ref = self.reference()["fig3_sawtooth"]
        rows = []

        def run():
            for want in ref:
                r = fig3.run_point(want["system"], want["vector_bytes"],
                                   device=self.dev)
                label = f"fig3 {want['system']} {want['vector_bytes']:.0f}"
                dg = r["goodput_gbps"] / want["goodput_gbps"] - 1
                dcv = r["cv"] - want["cv"]
                cv_tol = CV_ATOL + CV_RTOL * abs(want["cv"])
                log(f"   {label}: {r['goodput_gbps']:.2f} Gb/s ({dg:+.2e}) "
                    f"cv {r['cv']:.4g} (jax {want['cv']:.4g}) len "
                    f"{r['trace_len']} (jax {want['trace_len']}) "
                    f"n_iters {r['n_iters']}")
                self.check(r["trace_len"] == want["trace_len"],
                           f"{label}: trace length {r['trace_len']} != "
                           f"{want['trace_len']}")
                self.check(abs(dg) <= TIME_RTOL,
                           f"{label}: goodput off by {dg:+.3%}")
                self.check(abs(dcv) <= cv_tol,
                           f"{label}: cv {r['cv']} vs {want['cv']} (limit "
                           f"{cv_tol:.3g})")
                rows.append({**want, **r, "jax_cv": want["cv"], "cv_err": dcv,
                             "jax_goodput_gbps": want["goodput_gbps"]})
            return ("fabric_step_core",)

        self.path("fig3", run)
        for v in sorted({r["vector_bytes"] for r in rows}):
            ce = [r["cv"] for r in rows if r["vector_bytes"] == v
                  and r["system"] == "haicgu_ce8850"]
            others = [r["cv"] for r in rows if r["vector_bytes"] == v
                      and r["system"] != "haicgu_ce8850"]
            self.check(min(ce) > fig3.OBS1_FACTOR * max(others),
                       f"pin Obs. 1 at {v:.0f}: CE8850 cv {ce} <= "
                       f"{fig3.OBS1_FACTOR} x {max(others)}")
        self.report["fig3"] = rows

    def fig6(self):
        from benchmarks import pt_fig6_bursty as fig6
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        ref = self.reference()
        rows = []

        def run_grid(scen, grid, wants):
            t0, s0 = time.time(), sim.step_count
            results = scenarios.run_grid_spec(scen, grid, device=self.dev)
            self.torch.cuda.synchronize()
            wall, steps = time.time() - t0, sim.step_count - s0
            log(f"   fig6 {grid.system}/{grid.n_nodes}/{grid.aggressor} "
                f"{grid.sizes}: {steps} steps in {wall:.1f}s")
            for r in results:
                want = next(w for w in wants if (
                    w["system"], w["aggressor"], w["vector_bytes"],
                    w["profile"]) == (grid.system, grid.aggressor,
                                      r.vector_bytes, r.profile))
                row = self.hold(f"fig6 {grid.system}/{grid.n_nodes}/"
                                f"{grid.aggressor} {r.vector_bytes:.0f} "
                                f"{r.profile}", r, want, wall, steps)
                rows.append({**row, "burst_ms": want["burst_ms"],
                             "pause_ms": want["pause_ms"]})

        def run():
            quick = scenarios.get("fig6_bursty", True)
            for grid in quick.grids:
                run_grid(quick, grid, ref["fig6_bursty_quick"])
            system, aggr = "leonardo", "incast"
            full = scenarios.get("fig6_bursty", False)
            grid = fig6.grid_at_size(system, aggr, 2 << 20)
            run_grid(full, grid, ref["fig6_burst_pause"])
            return ("fabric_step_core",)

        self.path("fig6", run)
        steady = next(w["ratio"] for w in ref["fig5_steady"] if (
            w["system"], w["n_nodes"], w["aggressor"], w["vector_bytes"]) ==
            ("leonardo", 64, "incast", 2 << 20))
        grid2 = [r for r in rows if r["label"].startswith(
            f"fig6 leonardo/64/incast {2 << 20}")]
        self.check(len(grid2) == 9, f"burst x pause grid: {len(grid2)} rows")
        for r in grid2:
            if r["burst_ms"] == OBS3_SHORT_BURST_MS:
                self.check(r["ratio"] >= OBS3_SHORT_MIN,
                           f"pin Obs. 3: {r['label']} ratio {r['ratio']} < "
                           f"{OBS3_SHORT_MIN}")
            if r["burst_ms"] == OBS3_LONG_BURST_MS:
                self.check(abs(r["ratio"] / steady - 1) <= TIME_RTOL,
                           f"pin Obs. 3: {r['label']} ratio {r['ratio']} "
                           f"vs steady {steady}")
        self.report["fig6"] = rows

    # ---------------------------------------------------------------- 8
    def timing(self):
        import numpy as np
        torch = self.torch
        from repro_torch.kernels import fabric_step as fs, ref

        def graphed(fn):
            """One call of fn captured as a CUDA graph, so a replay costs
            the host a few microseconds whatever fn's Python overhead."""
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(3):
                    fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g.replay

        def med_ms(fn, n=60):
            """Median device time of one call between CUDA events, over n
            graph replays enqueued while the card sleeps, so no event pair
            spans host launch overhead. A failed capture fails the phase."""
            run = graphed(fn)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            host_s = (time.perf_counter() - t0) / 5
            torch.cuda._sleep(int(2e9 * host_s * n * 4) + 20_000_000)
            pairs = []
            for _ in range(n):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                run()
                e.record()
                pairs.append((s, e))
            torch.cuda.synchronize()
            times = [s.elapsed_time(e) for s, e in pairs]
            span = pairs[0][0].elapsed_time(pairs[-1][1])
            return float(np.median(times)), span / n

        self.timings = {}
        log(f"   {'shape':26s} {'kernel ms':>10s} {'plain ms':>10s} "
            f"{'bound ms':>10s}  bound by  (mean of the event span)")
        for label, (args, kw) in self.shapes.items():
            k, k_span = med_ms(lambda: fs.fabric_step_core(*args, **kw))
            pl, pl_span = med_ms(lambda: ref.fabric_step_core(*args, **kw))
            bound, by = bound_ms(args, kw)
            self.timings[label] = {
                "ms": k, "plain_ms": pl, "bound_ms": bound, "bound_by": by,
                "span_ms": k_span, "plain_span_ms": pl_span}
            log(f"   {label:26s} {k:10.4f} {pl:10.4f} {bound:10.6f}  {by}"
                f"  ({k_span:.4f} / {pl_span:.4f})")
        self.report["timing"] = self.timings

        from repro_torch.kernels import fused_reduce as fr
        self.fr_timings = {}
        log(f"   {'fused_accumulate f32':26s} {'kernel ms':>10s} "
            f"{'plain ms':>10s} {'add ms':>10s} {'bound ms':>10s}")
        for shape in FIG1_TILES:
            acc, x = self.fr_inputs(shape, "float32", "float32", seed=1)
            k, k_span = med_ms(lambda: fr.fused_accumulate(acc, x, 1.0))
            pl, pl_span = med_ms(lambda: ref.fused_accumulate(acc, x, 1.0))
            lib, lib_span = med_ms(lambda: torch.add(acc, x, alpha=1.0))
            bound, by = fr_bound_ms(acc, x)
            self.fr_timings[str(shape)] = {
                "ms": k, "plain_ms": pl, "library_ms": lib,
                "bound_ms": bound, "bound_by": by, "span_ms": k_span,
                "plain_span_ms": pl_span, "library_span_ms": lib_span}
            log(f"   {str(shape):26s} {k:10.4f} {pl:10.4f} {lib:10.4f} "
                f"{bound:10.6f}  {by}  ({k_span:.4f} / {pl_span:.4f} / "
                f"{lib_span:.4f})")
        self.report["timing_fused_accumulate"] = self.fr_timings

    # ------------------------------------------------------- diagnostic
    def profile_steps(self, n_steps=200):
        """Where an engine step's time goes on leonardo/256/incast: host
        wall per step, device busy time per step (torch.profiler), and the
        kernels that take it. A diagnostic: it checks nothing."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core.fabric import simulator as sim
        _, geom, p = self.grid_case("leonardo", 256, "ring_allgather",
                                    "incast")
        state = sim.init_state(geom, p)
        consts = sim.run_constants(p)

        def run(n):
            nonlocal state
            t0 = time.perf_counter()
            for _ in range(n):
                state, _ = sim._step_impl(geom, p, state, False,
                                          consts=consts)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run(20)
        wall_plain = run(n_steps)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = run(n_steps)
        cuda = torch.autograd.DeviceType.CUDA
        dev = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                getattr(e, "self_cuda_time_total", 0))
        kernels = sorted((e for e in prof.key_averages()
                          if getattr(e, "device_type", None) == cuda
                          and dev(e) > 0), key=dev, reverse=True)
        busy_us = sum(dev(e) for e in kernels)
        launches = sum(e.count for e in kernels)
        out = {"steps": n_steps,
               "wall_ms_per_step": 1e3 * wall_plain / n_steps,
               "wall_ms_per_step_profiled": 1e3 * wall / n_steps,
               "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
               "device_idle_share": 1 - busy_us / 1e6 / wall_plain,
               "device_kernels_per_step": launches / n_steps,
               "top": [(e.key[:60], dev(e) / n_steps, e.count // n_steps)
                       for e in kernels[:8]]}
        log(f"   leonardo/256/incast engine step: "
            f"{out['wall_ms_per_step']:.3f} ms wall "
            f"({out['wall_ms_per_step_profiled']:.3f} profiled), "
            f"{out['device_busy_ms_per_step']:.4f} ms device busy, idle "
            f"share {out['device_idle_share']:.3f}, "
            f"{out['device_kernels_per_step']:.0f} kernels/step")
        for name, us, cnt in out["top"]:
            log(f"      {us:9.2f} us/step x{cnt:<3d} {name}")
        self.report["profile"] = out


def leaf_tol(name, dt, ndim):
    """(atol, rtol) of a state or aux leaf in the lock-step check: bytes
    and rates at §13 (atol 1.0, rtol 2e-4); times at rtol 2e-4 and an atol
    of a thousandth of the cell's step (the delay integral qd_acc at that
    times dt); integers and flags exact."""
    dt = dt.double().view(-1, *[1] * (ndim - 1))
    if name in INT_LEAVES:
        return 0.0, 0.0
    if name in SECONDS_LEAVES:
        return 1e-3 * dt, FS_TOL["rtol"]
    if name == "qd_acc":
        return 1e-3 * dt * dt, FS_TOL["rtol"]
    return FS_TOL["atol"], FS_TOL["rtol"]


def bound_ms(args, kw):
    """Least time for one launch: every input read once, every output
    written once, over HBM bandwidth; or its float operations over the
    FP32 peak. The larger bounds it."""
    plinks, inject = args[0], args[1]
    B, F, H = plinks.shape
    L1 = args[4].shape[1]
    n_sw = kw["n_sw"]
    read = sum(a.numel() * a.element_size() for a in args)
    written = 4 * (2 * B * F + 3 * B * L1)
    flops = B * (5 * F + 8 * L1 + 5 * n_sw + H * (2 * F + 3 * L1) + 6 * L1)
    t_bytes = (read + written) / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def fr_bound_ms(acc, x):
    """Least time for one fused accumulate: acc and x read once, out
    written once, over HBM bandwidth; or its two float operations per
    element over the FP32 peak. The larger bounds it."""
    n = acc.numel()
    t_bytes = n * (2 * acc.element_size() + x.element_size()) \
        / HBM_BYTES_PER_S
    t_ops = 2 * n / FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an "
              "NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: src/repro_torch not found beside {__file__}",
              file=sys.stderr)
        return 2
    s = Smoke(torch)
    s.phase("device", s.device)
    s.phase("build", s.build)
    if s.failures:
        log("\n".join(s.failures))
        return 1
    for name, fn in (("kernel_vs_plain", s.kernel_vs_plain),
                     ("fused_accumulate_vs_plain", s.fr_vs_plain),
                     ("lockstep", s.lockstep), ("main_path", s.main_path),
                     ("fig1", s.fig1), ("fig3", s.fig3), ("fig6", s.fig6),
                     ("timing", s.timing)):
        s.phase(name, fn)
    try:  # diagnostic only: a profiler problem fails no check
        s.profile_steps()
    except Exception:
        log(f"profile diagnostic unavailable:\n{traceback.format_exc()}")
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    s.report["failures"] = s.failures
    with open(REPORT, "w") as f:
        json.dump(s.report, f, indent=1, default=str)
    if s.failures:
        log(f"chip_smoke: {len(s.failures)} failure(s)")
        return 1
    t = s.timings[MAIN_SHAPE]
    t2 = s.fr_timings[str(MAIN_TILE)]
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": s.main_launches, "max_abs_err": s.main_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}, {
        **KERNEL2, "launches": s.fr_path_launches,
        "max_abs_err": s.fr_main_err, "ms": t2["ms"],
        "plain_ms": t2["plain_ms"], "bound_ms": t2["bound_ms"],
        "bound_by": t2["bound_by"], "library_ms": t2["library_ms"]}]}))
    print(s.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
