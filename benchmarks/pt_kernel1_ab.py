"""Kernel 1's time at ``chip_smoke.py``'s shapes, or the engine step's,
for one checkout of the repository, so that two commits can be compared
on one card in one call.

``python3 benchmarks/pt_kernel1_ab.py ROOT`` runs ROOT's own
``chip_smoke.py`` phases ``device``, ``build``, ``kernel_vs_plain`` and
``timing`` (ROOT's kernels, built into ROOT/build) and prints a ``RESULT``
line with kernel 1's ms a launch by shape. With ``--engine`` it runs
ROOT's ``profile_steps`` instead, ``--repeats`` times: the main path's
engine step at leonardo/256/incast (host wall ms a step and device busy
ms a step, from torch.profiler), and prints them on the ``RESULT`` line.
Run it once a checkout in its own process, in turns (parent, change,
change, parent), on the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--engine", action="store_true",
                    help="time the engine step instead of kernel 1")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "src")]
    import torch

    import chip_smoke

    smoke = chip_smoke.Smoke(torch)
    t0 = time.time()
    if args.engine:
        smoke.device()
        smoke.build()
        runs = []
        for _ in range(args.repeats):
            smoke.profile_steps(n_steps=args.steps)
            prof = smoke.report["profile"]
            runs.append({k: prof[k] for k in (
                "wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share", "device_kernels_per_step")})
        result = {"engine_leonardo_256_incast": runs}
    else:
        for phase in (smoke.device, smoke.build, smoke.kernel_vs_plain,
                      smoke.timing):
            phase()
        result = {label: t["ms"] for label, t in smoke.timings.items()}
    print(f"{root}: failures {smoke.failures}, {time.time() - t0:.0f}s")
    print("RESULT", root, json.dumps(result))
    return 1 if smoke.failures else 0


if __name__ == "__main__":
    sys.exit(main())
