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

* the mitigation panel reports a baseline-guarded winner per fabric for
  the flapping-link panel (``score.winners_by_system``), the same
  winners as the JAX package's where it scored the same panel
  (``jax_reference.json["fault_panel"]``);
* a ``runtime/fault.StepMonitor`` fed the replayed per-step victim
  queue-delay stream of a flap run trips inside the flap window, and
  after the elastic-rescale response (``elastic_plan`` +
  ``reset(rebaseline=True)``) stays untripped in the degraded steady
  state;

and each family's agreement with the JAX package's rows
(``pt_common.jax_agreement``). Any failed check raises (and ``python -m``
exits non-zero).

``PYTHONPATH=src python -m benchmarks.pt_fault_scenarios [--quick]
[--force] [--device cpu] [--cache-dir DIR]``
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmarks.pt_common import (REFERENCE, default_cache_dir,
                                  jax_agreement, scenario_rows, size_label)
from repro_torch.core import bench, congestion as cong, scenarios
from repro_torch.core.fabric import simulator as sim, systems
from repro_torch.core.fabric.routing import POLICY_ADAPTIVE, POLICY_ECMP
from repro_torch.core.fabric.simulator import resolve_device
from repro_torch.core.mitigation import score
from repro_torch.core.mitigation.search import Candidate
from repro_torch.kernels import fabric_step
from repro_torch.runtime import fault as rfault

GATE_STEPS = 48  # inertness-gate length (covers several flap slots)
GATE_NODES = 8  # leonardo allocation of the gate, as the reference's
# the monitor demo's replay: steps and the StepMonitor window in steps
MONITOR_STEPS, MONITOR_WINDOW = 600, 20


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


def fault_panel(quick: bool, device) -> Dict:
    """Per-fabric mitigation winners on the flapping-link panel (the quick
    ``link_fault`` grids), as ``benchmarks/fault_scenarios.py``'s ``fault_panel``: three
    candidates and the default in one batch."""
    panel = score.panel_from_scenario(score.FAULT_PANEL_SCENARIO,
                                      quick=True)
    cands = [Candidate(policy=POLICY_ECMP), Candidate(policy=POLICY_ADAPTIVE),
             Candidate(cc=(("hol_factor", 0.45),))]
    print(f"\n# fault panel: {len(cands) + 1} candidates x {len(panel)} "
          "flap/degrade cells (one batch)")
    steps0, launches0 = sim.step_count, fabric_step.launches
    t0 = time.time()
    scores = score.score_table(panel, cands, n_iters=8 if quick else 12,
                               warmup=2 if quick else 3, max_steps=120_000,
                               device=device)
    wall = time.time() - t0
    runs = [r for s in scores for r in s.cells]
    winners = score.winners_by_system(runs)
    ok = bool(winners)
    for sysname, w in winners.items():
        ok &= bool(np.isfinite(w.ratio_min))
        print(f"#   {sysname}: winner {w.candidate} "
              f"(ratio_min={w.ratio_min:.3f}, jain={w.jain:.3f}, "
              f"base_rel={w.t_base_worst_rel:.3f})")
    got = {s: w.candidate for s, w in winners.items()}
    # JAX's winners of this very panel: the quick panel fails without
    # them; the full one may run where JAX has not scored it
    try:
        with open(REFERENCE) as f:
            want = json.load(f).get("fault_panel", {}).get(
                "quick" if quick else "full")
    except OSError:
        want = None
    if want is None or sorted(want["cells"]) != sorted(c.name
                                                       for c in panel):
        same = not quick
        note = "JAX has not scored this panel" + (
            ": its winners are required" if quick else "")
    else:
        same = got == want["winners"]
        note = (f"winners {'equal' if same else 'DIFFER from'} JAX's "
                f"{want['winners']}")
    print(f"# fault panel: {wall:.1f}s, {sim.step_count - steps0} engine "
          f"steps, {fabric_step.launches - launches0} kernel-1 launches; "
          f"{note}")
    print(f"# fault-panel check: baseline-guarded winner per fabric -> "
          f"{'REPRODUCED' if ok and same else 'MISMATCH'}")
    return {"ok": ok and same, "winners": got,
            "ratio_min": {s: w.ratio_min for s, w in winners.items()},
            "wall_s": wall}


def monitor_stream(device, steps: int = MONITOR_STEPS):
    """The per-step mean victim queue delay (seconds) of a flap run on
    leonardo/8 (AllGather at 2 MiB, no aggressor; the hot link flaps at
    duty 0.9 from mid-replay to the end), and the run's dt and latency."""
    sysp = systems.get_system("leonardo")
    case = bench.build_case(sysp, 8, "ring_allgather", "")
    v = 2 << 20
    dt = bench.choose_dt(case.topo, case.n_victims, v, case.lat())
    t_fault = 0.5 * steps * dt
    prof = cong.with_faults(cong.no_congestion(),
                            cong.flap(t_fault, 10.0, duty=0.9, seed=5))
    p = sim.stack_params([case.cell_params(v, prof, dt,
                                           with_fault_table=True)]).to(device)
    geom = case.geom.to(device)
    state = sim.init_state(geom, p)
    qdel = []
    for _ in range(steps):
        state, _, aux = sim.step_debug(geom, p, state)
        total, = sim.victim_sums([aux["qdel"] * geom.is_victim],
                                 geom.victim_end)
        qdel.append(total / geom.n_victims)
    return torch.cat(qdel).cpu().numpy(), dt, case.lat(), t_fault, geom


def monitor_demo(device) -> Dict:
    """Coordinator-side detection on the replayed queue-delay stream: a
    StepMonitor (window duration = base step latency + mean queue delay,
    through its injectable clock) must trip inside the flap window, and
    after the elastic-rescale response (elastic_plan +
    reset(rebaseline=True)) accept the degraded steady state."""
    qdel, dt, lat, t_fault, geom = monitor_stream(device)
    durs = [lat + float(np.mean(w))
            for w in qdel.reshape(-1, MONITOR_WINDOW)]
    fault_win = int(t_fault / dt) // MONITOR_WINDOW
    clock_t = [0.0]
    mon = rfault.StepMonitor(threshold=2.5, trip_after=3,
                             clock=lambda: clock_t[0])
    tripped_at, plan = None, None
    for i, d in enumerate(durs):
        mon.start_step()
        clock_t[0] += d
        mon.end_step(i)
        if mon.tripped and tripped_at is None:
            tripped_at = i
            plan = rfault.elastic_plan(int(geom.n_src) - 1, 2)
            mon.reset(rebaseline=True, window=3)
    retripped = mon.tripped or (tripped_at is not None
                                and any(st.flagged for st in
                                        mon.history[tripped_at + 1:]))
    ok = (tripped_at is not None and tripped_at >= fault_win
          and not retripped)
    print(f"\n# monitor demo: qdel windows clean "
          f"{np.mean(durs[:fault_win]) * 1e6:.1f}us -> flap "
          f"{np.mean(durs[fault_win:]) * 1e6:.1f}us; tripped at window "
          f"{tripped_at} (flap enters at {fault_win}), elastic_plan -> "
          f"{plan}, post-reset tripped={mon.tripped} -> "
          f"{'REPRODUCED' if ok else 'MISMATCH'}")
    return {"ok": ok, "tripped_window": tripped_at,
            "fault_window": fault_win, "plan": list(plan) if plan else None,
            "retripped_after_reset": bool(retripped)}


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
    panel = fault_panel(quick, device)
    mon = monitor_demo(device)
    print(f"\n[pt_fault_scenarios] done in {time.time() - t0:.0f}s")
    failed = [k for k, ok in (("inertness", ok_inert),
                              ("flap", c["ok_flap"]),
                              ("dying optic", c["ok_optic"]),
                              ("intra-node", c["ok_intra"]),
                              ("fault panel", panel["ok"]),
                              ("monitor", mon["ok"])) if not ok]
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
