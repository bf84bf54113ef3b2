"""Roofline aggregation of the port's dry-run artifacts, as the
reference's ``launch/roofline.py``: per (arch x shape) the three-term
roofline, the bottleneck, the MODEL_FLOPS ratio and a one-line advice.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh single]
        [--json]

Terms (seconds per step; the artifact counts one rank's program):
    compute_s    = FLOPs / chip.peak_flops
    memory_s     = bytes / chip.hbm_bw
    collective_s = wire bytes / chip.link_bw

The chip's constants are one named argument (:class:`Chip`, default
``H100``), never module globals. ``V5E`` holds the reference's (197e12 FLOP/s bf16, 819e9 B/s HBM,
50e9 B/s a link, 16e9 B); ``H100`` the NVIDIA H100 SXM5 80GB datasheet's:
989e12 FLOP/s dense bf16 tensor core, 3.35e12 B/s HBM3, 80e9 B, and 450e9
B/s a direction over NVLink 4 (the datasheet's 900 GB/s of NVLink
bandwidth a GPU, both directions together). Every number here is a count
with those constants, not a measurement. With ``V5E`` every function
returns what the reference's returns on the same cell dicts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Chip:
    name: str
    peak_flops: float  # bf16 dense, FLOP/s
    hbm_bw: float  # B/s
    link_bw: float  # B/s a link, one direction
    hbm_per_chip: float  # B


V5E = Chip("TPU v5e (the reference's constants)", 197e12, 819e9, 50e9,
           16e9)
H100 = Chip("H100 80GB HBM3 (datasheet constants)", 989e12, 3.35e12, 450e9,
            80e9)

ARTIFACTS = os.environ.get("REPRO_TORCH_DRYRUN_DIR") or os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")


def load_cells(mesh: str = "single", variant: str = "") -> List[Dict]:
    from repro_torch.configs import all_arch_names
    from repro_torch.configs.base import SHAPES

    base = ARTIFACTS if not variant else ARTIFACTS + "_" + variant
    cells = []
    for arch in all_arch_names():
        for shape in SHAPES:
            path = os.path.join(base, f"{arch}__{shape}__{mesh}.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                cells.append(json.load(f))
    return cells


def _advice(cell: Dict, chip: Chip = H100) -> str:
    r = cell["roofline"]
    bn = r["bottleneck"]
    coll = cell["hlo"]["collectives"]["per_kind"]
    top_kind = max(coll, key=lambda k: coll[k]["wire_bytes"]) if coll else ""
    if bn == "collective_s":
        return (f"dominant wire bytes are {top_kind}; cut by resharding "
                "(fewer per-layer weight gathers), fusing RS+AG into the "
                "step, or compressing the slow-axis payload")
    if chip is V5E:
        if bn == "memory_s":
            return ("HBM traffic dominated by remat re-reads / attention "
                    "intermediates; relax the checkpoint policy or chunk "
                    "attention to keep the working set in VMEM")
        return ("MXU-bound: increase arithmetic intensity per pass (fused "
                "kernels) or accept — compute-bound is the roofline target")
    if bn == "memory_s":
        return ("HBM traffic dominated by remat re-reads and float32 "
                "intermediates; fuse the elementwise glue into the "
                "kernels or relax the checkpoint policy")
    return ("tensor-core-bound: raise the kernels' achieved FLOP/s, or "
            "accept — compute-bound is the roofline target")


def analyze_cell(cell: Dict, chip: Chip = H100) -> Optional[Dict]:
    if cell.get("status") != "ok":
        return None
    r = cell["roofline"]
    bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
    out = {
        "arch": cell["arch"], "shape": cell["shape"],
        "n_devices": cell["n_devices"],
        "compute_s": r["compute_s"], "memory_s": r["memory_s"],
        "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
        "bound_s": bound,
        "peak_gb": cell["memory"].get("peak_per_device_bytes", 0) / 1e9,
        "fits_hbm": cell["memory"].get("peak_per_device_bytes", 1e30)
        <= chip.hbm_per_chip,
        "advice": _advice(cell, chip),
    }
    mf = cell.get("model_flops")
    if mf:
        t_useful = mf["model_flops_per_device"] / chip.peak_flops
        out["useful_flops_fraction"] = mf["useful_fraction"]
        out["roofline_fraction"] = t_useful / bound if bound else 0.0
    else:
        # serving is bandwidth work: the floor is streaming the sharded
        # params once (+ the KV cache once for decode); RL-frac = that
        # floor over the achieved bound
        t_useful = _serving_useful_s(cell, chip)
        out["roofline_fraction"] = (t_useful / bound) if bound else 0.0
        out["useful_flops_fraction"] = None
    return out


def _serving_useful_s(cell: Dict, chip: Chip = H100) -> float:
    """Minimal HBM seconds for a serving step: sharded params read once,
    plus (decode) the KV/state cache read once."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES

    cfg = get_config(cell["arch"])
    shape = SHAPES[cell["shape"]]
    n_dev = cell["n_devices"]
    param_bytes = cfg.param_count() * 2 / n_dev  # bf16, fully sharded
    kv_bytes = 0.0
    if shape.kind == "decode":
        B, S = shape.global_batch, shape.seq_len
        if cfg.n_kv_heads:
            s_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
            kv_bytes += (cfg.n_layers * B * s_eff * cfg.n_kv_heads
                         * cfg.resolved_head_dim * 2 * 2)
        if cfg.ssm_state:
            kv_bytes += (cfg.n_layers * B * cfg.resolved_d_inner
                         * cfg.ssm_state * 4)
        kv_bytes /= n_dev
        return (param_bytes + kv_bytes) / chip.hbm_bw
    # prefill is forward compute: useful = 2*N_active*tokens FLOPs, floored
    # by streaming the params once
    B, S = shape.global_batch, shape.seq_len
    t_flops = 2.0 * cfg.active_param_count() * B * S / n_dev \
        / chip.peak_flops
    return max(t_flops, param_bytes / chip.hbm_bw)


def table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':<18} {'shape':<12} {'compute_s':>10} {'memory_s':>10} "
           f"{'collect_s':>10} {'bound_s':>9} {'bottleneck':>12} "
           f"{'RL-frac':>8} {'useful':>7} {'GB/dev':>7} {'fits':>5}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        uf = r["useful_flops_fraction"]
        lines.append(
            f"{r['arch']:<18} {r['shape']:<12} {r['compute_s']:>10.3f} "
            f"{r['memory_s']:>10.3f} {r['collective_s']:>10.3f} "
            f"{r['bound_s']:>9.3f} {r['bottleneck'][:-2]:>12} "
            f"{r['roofline_fraction']:>8.3f} "
            f"{uf if uf is not None else float('nan'):>7.3f} "
            f"{r['peak_gb']:>7.1f} {'y' if r['fits_hbm'] else 'N':>5}")
    return "\n".join(lines)


def pick_hillclimb_cells(rows: List[Dict]) -> Dict[str, Dict]:
    """The three §Perf cells: worst roofline fraction (train), most
    collective-bound, most representative of the paper's technique.
    The cells are kept distinct: kimi train_4k is both the largest
    collective term AND the paper-representative cell (EP all-to-all MoE
    dispatch == the paper's AlltoAll congestion pattern), so the
    collective slot takes the runner-up."""
    rep = next(r for r in rows
               if r["arch"] == "kimi-k2-1t-a32b" and r["shape"] == "train_4k")
    train = [r for r in rows if r["shape"] == "train_4k"]
    worst = min((r for r in train if r is not rep),
                key=lambda r: r["roofline_fraction"])
    coll = max((r for r in rows if r is not rep and r is not worst),
               key=lambda r: r["collective_s"]
               * (r["bottleneck"] == "collective_s"))
    return {"worst_roofline": worst, "most_collective_bound": coll,
            "paper_representative": rep}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="single", choices=["single", "multi"])
    p.add_argument("--variant", default="",
                   help="read artifacts/dryrun_torch_<variant>/ instead")
    p.add_argument("--json", action="store_true")
    args = p.parse_args()
    chip = H100
    rows = [a for a in (analyze_cell(c, chip)
                        for c in load_cells(args.mesh, args.variant)) if a]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(f"# {chip.name}: {chip.peak_flops:.4g} FLOP/s, "
              f"{chip.hbm_bw:.4g} B/s HBM, {chip.link_bw:.4g} B/s a link, "
              f"{chip.hbm_per_chip:.4g} B; a count, not a measurement")
        print(table(rows))
        picks = pick_hillclimb_cells(rows)
        print("\n# hillclimb cells (§Perf):")
        for why, r in picks.items():
            print(f"#  {why:<24} {r['arch']} x {r['shape']} "
                  f"(RL-frac {r['roofline_fraction']:.3f}, "
                  f"{r['bottleneck']})")
    tag = f"_{args.variant}" if args.variant else ""
    out = os.path.join(ARTIFACTS, f"roofline{tag}_h100_{args.mesh}.json")
    os.makedirs(ARTIFACTS, exist_ok=True)
    with open(out, "w") as f:
        json.dump({"chip": dataclasses.asdict(chip), "rows": rows}, f,
                  indent=1)


if __name__ == "__main__":
    main()
