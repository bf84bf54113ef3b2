#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

Builds the port's CUDA kernel from ``src/repro_torch/csrc`` (into
``build/`` on first use), then:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the fabric-step kernel and reports the build time;
3. holds the kernel against its plain PyTorch version on the card at the
   characterization grids' shapes and on random shapes, with and without
   the aux observer (DESIGN.md §13 tolerance, bit-exact where every
   segment has one contributor) and checks two launches agree bitwise;
4. runs 50 lock-step engine steps with the kernel and with the plain
   version on leonardo/64/incast and cresco8/256/alltoall;
5. drives the main path: the fig4_nslb quick points and four fig5_steady
   quick grids through ``repro_torch.core.scenarios`` on the card, held to
   ``artifacts/bench_cache_torch/jax_reference.json`` (equal iteration
   counts, times within 2%) and to the paper's behaviour pins, and checks
   that every engine step launched the kernel once;
6. times the kernel, its plain version and its memory bound per shape.

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
        from repro_torch.kernels import fabric_step as fs
        t0 = time.time()
        lib = fs.build()
        fs._load()
        self.report["build_s"] = time.time() - t0
        log(f"built {os.path.relpath(lib, ROOT)} in {time.time() - t0:.1f}s")
        for line in fs.build_log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log("   ptxas:", line.strip())

    # ------------------------------------------------------------ inputs
    def grid_case(self, system, n, victim, aggr):
        """A grid's geometry and stacked params on the card, as run_grid
        builds them (sizes x baseline/steady)."""
        from repro_torch.core import bench, congestion as cong
        from repro_torch.core.fabric import simulator as sim, systems
        case = bench.build_case(systems.get_system(system), n, victim, aggr)
        sizes = (4 << 20, 16 << 20) if system.startswith("nanjing") \
            else (32 << 10, 2 << 20)
        profiles = (cong.steady(),)
        dts = bench._cell_dts(case, sizes, 1, None, case.lat())
        cells = [(float(v), pr) for v in sizes
                 for pr in [cong.no_congestion(), *profiles]]
        params = sim.stack_params([case.cell_params(v, pr, d) for (v, pr), d
                                   in zip(cells, dts)])
        return case, case.geom.to(self.dev), params.to(self.dev)

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

    # ---------------------------------------------------------------- 4
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

    # ---------------------------------------------------------------- 5
    def main_path(self):
        torch = self.torch
        from repro_torch.core import scenarios
        from repro_torch.core.fabric import simulator as sim
        from repro_torch.kernels import fabric_step as fs
        with open(REFERENCE) as f:
            ref = json.load(f)
        log(f"   reference: jax {ref['jax_version']} "
            f"({ref['jax_backend']}) commit {ref['commit'][:12]}")
        rows = []
        fs.launches = 0
        sim.step_count = 0
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

    # ---------------------------------------------------------------- 6
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
                     ("lockstep", s.lockstep), ("main_path", s.main_path),
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
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": s.main_launches, "max_abs_err": s.main_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}))
    print(s.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
