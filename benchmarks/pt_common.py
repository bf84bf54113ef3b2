"""Shared plumbing of the port's benchmark drivers: CSV cache (resumable
sweeps) and table printing, as ``benchmarks/common.py`` does for the JAX
package.

The port's rows go under ``artifacts/bench_cache_torch/<device type>/``
(``cuda`` or ``cpu``), never into the JAX package's
``artifacts/bench_cache/``; every row names the device it ran on.
"""
from __future__ import annotations

import csv
import json
import math
import os
from typing import Callable, Dict, Iterable, List

import torch

CACHE_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "artifacts", "bench_cache_torch")
# the JAX package's rows (benchmarks/pt_jax_reference.py)
REFERENCE = os.path.join(CACHE_ROOT, "jax_reference.json")


def device_name(device: torch.device) -> str:
    """The name a result row carries: the card's name, or 'cpu'."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def default_cache_dir(device: torch.device) -> str:
    return os.path.join(CACHE_ROOT, device.type)


def _load_cache(cache_dir: str, name: str, keys: List[str],
                force: bool) -> "tuple[str, Dict[tuple, Dict]]":
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}.csv")
    cache: Dict[tuple, Dict] = {}
    if os.path.exists(path) and not force:
        with open(path) as f:
            lines = (line for line in f if not line.startswith("#"))
            for row in csv.DictReader(lines):
                # rows from an older cache layout (missing a key column)
                # are treated as misses and recomputed
                if any(row.get(k) in (None, "") for k in keys):
                    continue
                cache[tuple(row[k] for k in keys)] = row
    return path, cache


def cached_sweep(name: str, keys: List[str], points: Iterable[tuple],
                 fn: Callable[..., Dict], *, cache_dir: str,
                 force: bool = False) -> List[Dict]:
    """Run ``fn(*point) -> dict`` per point, caching rows to a CSV keyed by
    the point tuple — re-running a partially completed sweep only computes
    the missing cells."""
    path, cache = _load_cache(cache_dir, name, keys, force)
    rows = []
    for point in points:
        key = tuple(str(p) for p in point)
        if key in cache:
            rows.append(cache[key])
            continue
        out = fn(*point)
        row = {**dict(zip(keys, key)), **{k: str(v) for k, v in out.items()}}
        rows.append(row)
        cache[key] = row
        _write(path, keys, cache)
    return rows


SCENARIO_KEYS = ["system", "n_nodes", "victim", "aggressor", "vector_bytes",
                 "profile"]


def expected_grid_keys(grid) -> "List[tuple]":
    """The cache-key tuples one grid's rows carry, in result order; a
    scale-batched grid expands its (system, n_nodes) cells."""
    from repro_torch.core import bench

    vic = bench.resolve_victim_label(grid.victim, grid.phased,
                                     list(grid.jobs) or None)
    cells = list(grid.cells) or [(grid.system, grid.n_nodes)]
    return [(s, str(n), vic, grid.aggressor or "none", str(float(v)),
             p.label())
            for s, n in cells for v in grid.sizes for p in grid.profiles]


def scenario_rows(scenario, *, device: torch.device, cache_dir: str,
                  force: bool = False) -> List[Dict]:
    """Run a registered scenario through ``repro_torch.core.scenarios``
    with grid-level CSV caching: a grid whose cells are all cached is
    skipped; otherwise the whole grid re-runs as one batched run."""
    from repro_torch.core import scenarios as scen

    path, cache = _load_cache(cache_dir, scenario.name, SCENARIO_KEYS, force)
    rows = []
    for grid in scenario.grids:
        expected = expected_grid_keys(grid)
        if all(k in cache for k in expected):
            rows.extend(cache[k] for k in expected)
            continue
        for r in scen.run_grid_spec(scenario, grid, device=device):
            row = {k: str(v) for k, v in scen.result_row(grid, r).items()}
            row["device"] = device_name(device)
            cache[tuple(row[k] for k in SCENARIO_KEYS)] = row
            rows.append(row)
        _write(path, SCENARIO_KEYS, cache)
    return rows


def _row_key(r) -> tuple:
    return (r["system"], int(r["n_nodes"]), r["victim"], r["aggressor"],
            float(r["vector_bytes"]), r["profile"])


def jax_agreement(name: str, rows: List[Dict], quick: bool,
                  reference: str = REFERENCE) -> str:
    """One line comparing a family's rows with the JAX package's rows of
    the same grids (``scenarios_quick`` or ``scenarios_full`` of
    ``reference``): how many rows have a JAX twin, how many ratios agree
    to the CSV's 4 digits, the largest ratio difference and the largest
    relative time difference (at the CSV's 0.1 us rounding); and the
    JAX grids that did not finish."""
    try:
        with open(reference) as f:
            doc = json.load(f)
    except OSError:
        return f"{name}: no JAX rows ({reference} missing)"
    if quick:
        want, missing = doc.get("scenarios_quick", {}).get(name) or [], []
    else:
        entries = doc.get("scenarios_full", {}).get(name) or []
        want = [r for e in entries for r in e["rows"] or []]
        missing = [e for e in entries if e["rows"] is None]
    by_key = {_row_key(w): w for w in want}
    n = same = 0
    d_ratio = d_time = 0.0
    for r in rows:
        w = by_key.get(_row_key(r))
        if w is None:
            continue
        n += 1
        ratio = float(r["ratio"])
        if math.isnan(ratio) or math.isnan(w["ratio"]):
            same += math.isnan(ratio) and math.isnan(w["ratio"])
            continue
        same += ratio == round(w["ratio"], 4)
        d_ratio = max(d_ratio, abs(ratio - w["ratio"]))
        for col, k in (("t_uncongested_us", "t_uncongested_s"),
                       ("t_congested_us", "t_congested_s")):
            d_time = max(d_time, abs(float(r[col]) / (w[k] * 1e6) - 1))
    out = (f"{name} vs JAX ({'quick' if quick else 'full'}): {n} of "
           f"{len(rows)} rows have a JAX row; ratios equal to 4 digits in "
           f"{same}, worst |ratio diff| {d_ratio:.2e}, worst time rel diff "
           f"{d_time:.2e}")
    if missing:
        out += (f"; {len(missing)} JAX grid(s) did not finish: "
                + ", ".join(f"{e['aggressor'] or 'none'} ({e['not_finished']})"
                            for e in missing))
    return out


def _write(path: str, keys: List[str], cache: Dict[tuple, Dict]):
    fields: List[str] = []
    for row in cache.values():
        for k in row:
            if k not in fields:
                fields.append(k)
    tmp = path + ".tmp"
    with open(tmp, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for row in cache.values():
            w.writerow(row)
    os.replace(tmp, path)


def heatmap(rows: List[Dict], x: str, y: str, val: str,
            fmt: str = "{:>7.2f}") -> str:
    xs = sorted({r[x] for r in rows}, key=_num)
    ys = sorted({r[y] for r in rows}, key=_num)
    grid = {(r[y], r[x]): float(r[val]) for r in rows}
    out = [" " * 12 + "".join(f"{str(v):>8}" for v in xs)]
    for yy in ys:
        line = f"{str(yy):>12}"
        for xx in xs:
            v = grid.get((yy, xx))
            line += fmt.format(v) if v is not None else " " * 7 + "-"
        out.append(line)
    return "\n".join(out)


def _num(s):
    try:
        return float(s)
    except (TypeError, ValueError):
        return s


def size_label(b: float) -> str:
    b = float(b)
    for unit, div in (("GiB", 2 ** 30), ("MiB", 2 ** 20), ("KiB", 2 ** 10)):
        if b >= div:
            return f"{b / div:g}{unit}"
    return f"{b:g}B"
