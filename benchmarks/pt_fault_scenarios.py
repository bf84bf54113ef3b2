"""Link faults and the intra-node (NVLink/PCIe) stage on the port:
flapping links, dying optics, fabric jitter and outages, and a
node-capacity sweep, as ``benchmarks/fault_scenarios.py`` runs them on the
JAX package, with its engine checks:

* inertness gate: an all-``none`` fault table, and the intra-node stage
  at ``node_cap = inf``, give every state leaf and the goodput bit for
  bit as the engine without them, over ``GATE_STEPS`` steps (on the card
  through kernel 1, on the CPU through its plain version);
* the hot-link flap costs: every flap ratio < 0.9;
* the dying optic costs: every degrade ratio < 0.95;
* the intra-node stage is monotone: mean ratio non-increasing (0.05
  slack) as the node's capacity fraction shrinks, the tightest at least
  0.05 below the loosest;

and each family's agreement with the JAX package's rows
(``pt_common.jax_agreement``).

The reference driver's mitigation panel and its StepMonitor demo need
the mitigation lab (ROADMAP Queue 1 item 12) and the metrics carry (item
6); this driver says so and runs neither. Any failed check raises (and
``python -m`` exits non-zero).

``PYTHONPATH=src python -m benchmarks.pt_fault_scenarios [--quick]
[--force] [--device cpu] [--cache-dir DIR]``
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.pt_common import (default_cache_dir, jax_agreement,
                                  scenario_rows, size_label)
from repro_torch.core import bench, congestion as cong, scenarios
from repro_torch.core.fabric import simulator as sim, systems
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.kernels import fabric_step

GATE_STEPS = 48  # inertness-gate length (covers several flap slots)
GATE_NODES = 8  # leonardo allocation of the gate, as the reference's
WAITING = {
    "fault_panel": "the mitigation lab (ROADMAP Queue 1 item 12)",
    "monitor_demo": "the metrics carry (ROADMAP Queue 1 item 6)",
}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, NaN payloads included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.contiguous().view(as_int), b.contiguous().view(as_int)
    return bool(torch.equal(a, b))


def _run_steps(geom, p, n_steps: int):
    state = sim.init_state(geom, p)
    goodput = []
    for _ in range(n_steps):
        state, gp = sim.step(geom, p, state)
        goodput.append(gp)
    return state, torch.stack(goodput, 1)


def inertness_gate(device, n_nodes: int = GATE_NODES,
                   n_steps: int = GATE_STEPS) -> Dict[str, List[str]]:
    """Leonardo, ``n_nodes`` nodes, AllGather under steady incast at 32
    KiB and 2 MiB: the engine with the all-``none`` table (``table``) and
    with the intra-node stage at inf (``intra``) against the engine
    without either, ``n_steps`` steps. Returns, per variant, the state
    leaves (and ``goodput``) whose bits differ."""
    sysp = systems.get_system("leonardo")
    case = bench.build_case(sysp, n_nodes, "ring_allgather", "incast")
    case_in = bench.build_case(sysp, n_nodes, "ring_allgather", "incast",
                               intra_node=True)

    def params(c, **kw):
        cells = []
        for v in (32 << 10, 2 << 20):
            dt = bench.choose_dt(c.topo, c.n_victims, v, c.lat())
            cells.append(c.cell_params(v, cong.steady(), dt, **kw))
        return sim.stack_params(cells).to(device)

    geom, geom_in = case.geom.to(device), case_in.geom.to(device)
    base = _run_steps(geom, params(case), n_steps)
    runs = {"table": _run_steps(geom, params(case, with_fault_table=True),
                                n_steps),
            "intra": _run_steps(geom_in, params(case_in), n_steps)}
    out = {}
    for name, (state, gp) in runs.items():
        bad = [k for k in base[0] if not same_bits(state[k], base[0][k])]
        out[name] = bad + ([] if same_bits(gp, base[1]) else ["goodput"])
    return out


def print_rows(name: str, rows: List[Dict]) -> None:
    print(f"\n# {name}")
    print(f"{'system':>10} {'n':>4} {'aggr':>8} {'size':>8} "
          f"{'profile':>42} {'ratio':>7}")
    for r in rows:
        print(f"{r['system']:>10} {r['n_nodes']:>4} {r['aggressor']:>8} "
              f"{size_label(r['vector_bytes']):>8} {r['profile']:>42} "
              f"{float(r['ratio']):>7.3f}")


def checks(rows_lf: List[Dict], rows_in: List[Dict]) -> Dict:
    """The reference driver's three claims on the family rows."""
    flap = [float(r["ratio"]) for r in rows_lf
            if "flap[" in r["profile"] and r["profile"].startswith("off")]
    optic = [float(r["ratio"]) for r in rows_lf
             if "degrade[" in r["profile"]]
    by_frac: Dict[float, List[float]] = {}
    for r in rows_in:
        frac = float(r["profile"].rsplit("+node", 1)[1].rstrip("x"))
        by_frac.setdefault(frac, []).append(float(r["ratio"]))
    fracs = sorted(by_frac, reverse=True)
    means = [float(np.mean(by_frac[f])) for f in fracs]
    return {
        "flap": flap, "ok_flap": bool(flap) and max(flap) < 0.9,
        "optic": optic, "ok_optic": bool(optic) and max(optic) < 0.95,
        "intra": dict(zip(fracs, means)),
        "ok_intra": bool(means)
        and all(b <= a + 0.05 for a, b in zip(means, means[1:]))
        and means[-1] < means[0] - 0.05}


def main(force: bool = False, quick: bool = False, device=None,
         cache_dir=None) -> List[Dict]:
    device = resolve_device(device)
    cache_dir = cache_dir or default_cache_dir(device)
    t0 = time.time()
    gate = inertness_gate(device)
    ok_inert = not any(gate.values())
    print(f"# inertness: all-none table & inf-cap node stage vs the engine "
          f"without them, {GATE_STEPS} steps on {device.type} -> "
          + ("bit-identical" if ok_inert else f"MISMATCH {gate}"))
    rows = {}
    for name in ("link_fault", "intra_node"):
        scen = scenarios.get(name, quick)
        steps0, launches0 = sim.step_count, fabric_step.launches
        t1 = time.time()
        rows[name] = scenario_rows(scen, device=device, cache_dir=cache_dir,
                                   force=force)
        print_rows(f"{name} — {scen.description}", rows[name])
        print(f"# {name}: {len(rows[name])} rows in {time.time() - t1:.1f}s, "
              f"{sim.step_count - steps0} engine steps, "
              f"{fabric_step.launches - launches0} kernel-1 launches")
        print(f"# {jax_agreement(name, rows[name], quick)}")
    c = checks(rows["link_fault"], rows["intra_node"])
    verdict = {True: "REPRODUCED", False: "MISMATCH"}
    print(f"\n# flap check: hot-link flap ratios "
          f"{[f'{x:.2f}' for x in c['flap']]} (all < 0.9) -> "
          f"{verdict[c['ok_flap']]}")
    print(f"# dying-optic check: degrade ratios "
          f"{[f'{x:.2f}' for x in c['optic']]} (all < 0.95) -> "
          f"{verdict[c['ok_optic']]}")
    print(f"# intra-node check: node-cap fracs {list(c['intra'])} -> mean "
          f"ratios {[f'{m:.2f}' for m in c['intra'].values()]} (monotone, "
          f"tightest frac hurts) -> {verdict[c['ok_intra']]}")
    for name, item in WAITING.items():
        print(f"# {name}: not run; it waits for {item}")
    print(f"\n[pt_fault_scenarios] done in {time.time() - t0:.0f}s")
    failed = [k for k, ok in (("inertness", ok_inert),
                              ("flap", c["ok_flap"]),
                              ("dying optic", c["ok_optic"]),
                              ("intra-node", c["ok_intra"])) if not ok]
    if failed:
        raise RuntimeError(f"fault checks failed: {failed}")
    return rows["link_fault"] + rows["intra_node"]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--quick", action="store_true")
    p.add_argument("--force", action="store_true",
                   help="ignore the scenario-row CSV cache")
    p.add_argument("--device", default=None)
    p.add_argument("--cache-dir", default=None)
    a = p.parse_args()
    try:
        main(quick=a.quick, force=a.force, device=a.device,
             cache_dir=a.cache_dir)
    except RuntimeError as e:
        print(f"[pt_fault_scenarios] {e}", file=sys.stderr)
        sys.exit(1)
