"""The port's dry run: one rank's step of every (arch x shape x mesh) cell,
counted on meta tensors, written in the reference's artifact layout
(``repro/launch/dryrun.py``) so both packages' ``roofline.analyze_cell``
read it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k [--mesh single|multi] [--smoke]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force]

Where the reference lowers and compiles a cell with XLA for 256 or 512
placeholder devices and parses the HLO, the port builds the model on the
``meta`` device (no memory, no card, no process) and runs one training,
prefill or decode step under ``launch.hlo_stats.StepCounter``. The
production layouts (``mesh.make_production_mesh``) count one rank's
program as the port runs it: the batch split over ``dp``, an MoE's expert
leaves split by EP and TP as ``moe.moe_ffn`` splits them, every other
layer whole on each rank (``"dense_tp": false`` in the artifact: the
reference's XLA partitions dense layers over the model axis, the port
does not yet). For the same reason a ``seq_shard`` config (``--variant
opt``) has no sequence parallelism to count: its cell is a skip with that
reason, as ``long_500k``'s inapplicable cells are. Collectives go to ``collectives.StandInGroup``s of the
layout's axis sizes, which record and move nothing. The roofline terms
use the H100's datasheet constants (``roofline.H100``); XLA's
``cost_analysis`` has no counterpart and the artifact says so.

``--smoke`` is the reference's: the reduced config, seq <= 512, batch
<= 8, the host layout (``make_host_mesh``: one rank here). Artifacts go
to ``artifacts/dryrun_torch/`` (``REPRO_TORCH_DRYRUN_DIR`` overrides),
never the reference's ``artifacts/dryrun/``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

from repro_torch.launch.roofline import ARTIFACTS, H100


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "", smoke: bool = False) -> dict:
    """Count one (arch x shape x mesh) cell and return its artifact."""
    import dataclasses as _dc

    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.hlo_stats import StepCounter
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         rules_for)
    from repro_torch.launch.steps import lower_cell

    cfg = get_config(arch)
    if variant:
        from repro_torch.configs.opt_variants import apply_variant
        cfg = apply_variant(cfg, variant)
    shape = SHAPES[shape_name]
    if shape_name not in [s.name for s in cfg.shapes()]:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip",
                "reason": "long_500k inapplicable: pure full-attention arch "
                          "(DESIGN.md §6)"}
    if cfg.seq_shard:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skip", "dense_tp": False,
                "reason": "seq_shard inapplicable: the port has no sequence "
                          "parallelism (dense_tp false)"}
    if smoke:
        cfg = cfg.reduced()
        shape = _dc.replace(shape, seq_len=min(shape.seq_len, 512),
                            global_batch=min(shape.global_batch, 8))
        layout = make_host_mesh()
    else:
        layout = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_dev = layout.size
    rules = rules_for(cfg, layout)

    t0 = time.time()
    lowered = lower_cell(cfg, shape, layout, rules)
    t_lower = time.time() - t0
    counter = StepCounter(attn_chunk=cfg.attn_chunk,
                          records=lowered.records)
    t0 = time.time()
    with counter:
        counter.arguments(lowered.arguments)
        outputs = lowered.run()
    stats = counter.result(outputs)
    t_count = time.time() - t0

    out = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "n_devices": n_dev, "status": "ok",
           "lower_s": round(t_lower, 2), "count_s": round(t_count, 2),
           "layout": dict(zip(layout.axis_names, layout.shape)),
           "dense_tp": False, "chip": H100.name}
    if smoke:
        out["smoke"] = True
    out["memory"] = stats["memory"]
    out["xla_cost_analysis"] = {
        "note": "no counterpart: XLA's single-visit cost_analysis of a "
                "compiled module; the port counts every op it runs "
                "(hlo_stats.StepCounter)"}
    out["hlo"] = {
        "flops_per_device": stats["flops"],
        "hbm_bytes_per_device": stats["hbm_bytes"],
        "collectives": stats["collectives"],
        "top_dots": stats["top_dots"][:8],
        "top_collectives": stats["top_collectives"][:8],
        "top_bytes": stats["top_bytes"][:12],
        "flops_aten": stats["flops_aten"],
        "flops_kernels": stats["flops_kernels"],
        "attention_recompute_flops": stats["attention_recompute_flops"],
        "kernel_calls": stats["kernel_calls"],
        "counted_by": "repro_torch.launch.hlo_stats.StepCounter on meta "
                      "tensors (FlopCounterMode + a TorchDispatchMode)",
    }

    # --- roofline terms (seconds), one rank's program ---
    wire = stats["collectives"]["total"]["wire_bytes"]
    operand = stats["collectives"]["total"]["operand_bytes"]
    terms = {
        "compute_s": stats["flops"] / H100.peak_flops,
        "memory_s": stats["hbm_bytes"] / H100.hbm_bw,
        "collective_s": wire / H100.link_bw,
        "collective_s_simple_recipe": operand / H100.link_bw,
    }
    terms["bottleneck"] = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms[k])
    out["roofline"] = terms

    # MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), training cells only
    if shape.kind == "train":
        n_active = cfg.active_param_count()
        tokens = shape.global_batch * shape.seq_len
        model_flops_global = 6.0 * n_active * tokens
        out["model_flops"] = {
            "n_params": cfg.param_count(),
            "n_active_params": n_active,
            "model_flops_global": model_flops_global,
            "model_flops_per_device": model_flops_global / n_dev,
            "useful_fraction": (model_flops_global / n_dev)
            / max(stats["flops"], 1.0),
        }
    return out


def cell_path(arch, shape, mesh_kind, variant="", smoke=False, base=""):
    base = base or (ARTIFACTS if not variant else ARTIFACTS + "_" + variant)
    os.makedirs(base, exist_ok=True)
    # smoke cells get their own filename so they can never shadow (or be
    # resumed as) a production artifact of the same cell
    suffix = "__smoke" if smoke else ""
    return os.path.join(base, f"{arch}__{shape}__{mesh_kind}{suffix}.json")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--mesh", default="single", choices=["single", "multi"])
    p.add_argument("--variant", default="",
                   help="optimization variant from configs/opt_variants.py; "
                        "results go to artifacts/dryrun_torch_<variant>/")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config + shrunken shape on the host "
                        "layout: a seconds-scale cell with the same "
                        "artifact layout")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape x mesh) cell, each in a "
                        "child process (resumable)")
    p.add_argument("--force", action="store_true")
    p.add_argument("--timeout", type=int, default=3600)
    args = p.parse_args()
    os.makedirs(ARTIFACTS, exist_ok=True)

    if args.all:
        from repro_torch.configs import all_arch_names
        from repro_torch.configs.base import SHAPES
        cells = [(a, s, m) for m in ("single", "multi")
                 for a in all_arch_names() for s in SHAPES]
        done = failed = 0
        for arch, shape, mesh_kind in cells:
            path = cell_path(arch, shape, mesh_kind, args.variant)
            if os.path.exists(path) and not args.force:
                done += 1
                continue
            print(f"[dryrun] {arch} x {shape} x {mesh_kind} ...", flush=True)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mesh_kind]
            if args.variant:
                cmd += ["--variant", args.variant]
            try:
                r = subprocess.run(cmd, timeout=args.timeout,
                                   env=dict(os.environ),
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    failed += 1
                    with open(path + ".err", "w") as f:
                        f.write(r.stdout[-4000:] + "\n" + r.stderr[-8000:])
                    print(f"  FAILED (see {path}.err)", flush=True)
                else:
                    done += 1
                    print("  ok", flush=True)
            except subprocess.TimeoutExpired:
                failed += 1
                with open(path + ".err", "w") as f:
                    f.write("timeout")
                print("  TIMEOUT", flush=True)
        print(f"[dryrun] complete: {done} ok, {failed} failed", flush=True)
        return

    assert args.arch and args.shape
    try:
        out = run_cell(args.arch, args.shape, args.mesh, args.variant,
                       smoke=args.smoke)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    path = cell_path(args.arch, args.shape, args.mesh, args.variant,
                     smoke=args.smoke)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, default=str)
    print(json.dumps({k: out[k] for k in ("arch", "shape", "mesh", "status")
                      if k in out}))
    if out["status"] == "ok":
        print("memory:", out["memory"])
        print("roofline:", out["roofline"])


if __name__ == "__main__":
    main()
