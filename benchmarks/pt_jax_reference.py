"""Reference rows for the PyTorch port, computed by the JAX package.

``PYTHONPATH=src python -m benchmarks.pt_jax_reference [--out PATH]``

Runs the fig4_nslb quick points and the fig5_steady quick grids that
``chip_smoke.py`` drives through ``repro_torch``, on the JAX package as it
stands, and writes ``artifacts/bench_cache_torch/jax_reference.json``: per
row the ratio, both iteration times, the completed iteration counts, dt,
the jax version and the git commit. It calls the benchmarks' row functions
directly and never ``cached_sweep``, so the committed CSVs under
``artifacts/bench_cache/`` are left as they are.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

OUT = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "bench_cache_torch", "jax_reference.json")

# fig5_steady quick grids the port is held to: (system, n_nodes, aggressor)
FIG5_GRIDS = (("leonardo", 64, "incast"), ("leonardo", 256, "incast"),
              ("lumi", 256, "incast"), ("cresco8", 256, "incast"))


def _commit() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], check=True,
                              capture_output=True, text=True,
                              cwd=os.path.dirname(__file__)).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _row(r, dt: float, seconds: float) -> dict:
    return {"system": r.system, "n_nodes": r.n_nodes, "victim": r.victim,
            "aggressor": r.aggressor, "profile": r.profile,
            "vector_bytes": r.vector_bytes, "ratio": r.ratio,
            "t_uncongested_s": r.t_uncongested_s,
            "t_congested_s": r.t_congested_s,
            "n_iters": list(r.n_iters), "dt": dt,
            "wall_s": seconds}


def fig4_rows() -> list:
    from benchmarks import fig4_nslb
    from repro.core import bench, congestion as cong, scenarios
    from repro.core.fabric import systems

    rows = []
    for mode, v in scenarios.get("fig4_nslb", True).points:
        sysp = systems.get_system("nanjing_nslb" if mode == "nslb"
                                  else "nanjing_ecmp")
        t0 = time.time()
        # the same call benchmarks.fig4_nslb.run_point makes, kept whole
        # so the row carries times and iteration counts beside the ratio
        r = bench.run_point(sysp, 8, "alltoall", "alltoall", float(v),
                            cong.steady(), n_iters=25, warmup=5)
        seconds = time.time() - t0
        fig4 = fig4_nslb.run_point(mode, float(v))
        if fig4["ratio"] != r.ratio:
            raise SystemExit(f"fig4 {mode} {v}: fig4_nslb ratio "
                             f"{fig4['ratio']} != run_point ratio {r.ratio}")
        case = bench.build_case(sysp, 8, "alltoall", "alltoall")
        dt = bench.choose_dt(case.topo, case.n_victims, float(v), case.lat(),
                             n_phases=case.max_phases)
        rows.append({"mode": mode, **_row(r, dt, seconds)})
        print(f"fig4 {mode} {v}: ratio {r.ratio} n_iters {r.n_iters} "
              f"({seconds:.1f}s)", flush=True)
    return rows


def fig5_rows() -> list:
    from repro.core import bench, scenarios

    scen = scenarios.get("fig5_steady", True)
    rows = []
    for system, n, aggr in FIG5_GRIDS:
        grid = next(g for g in scen.grids if (g.system, g.n_nodes,
                                              g.aggressor) == (system, n,
                                                               aggr))
        t0 = time.time()
        results = scenarios.run_grid_spec(scen, grid)
        seconds = time.time() - t0
        case = bench.build_case(bench.get_system(system), n, grid.victim,
                                aggr)
        for r in results:
            dt = bench.choose_dt(case.topo, case.n_victims, r.vector_bytes,
                                 case.lat(), n_phases=case.max_phases)
            rows.append(_row(r, dt, seconds))
            print(f"fig5 {system}/{n}/{aggr} {r.vector_bytes}: ratio "
                  f"{r.ratio} n_iters {r.n_iters} dt {dt} ({seconds:.1f}s)",
                  flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    import jax

    doc = {"source": "benchmarks/pt_jax_reference.py",
           "jax_version": jax.__version__,
           "jax_backend": jax.default_backend(),
           "commit": _commit(),
           "fig4_nslb": fig4_rows(),
           "fig5_steady": fig5_rows()}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
