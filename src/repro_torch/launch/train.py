"""Training launcher CLI of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --reduced --device cpu --steps 20

Runs on the CUDA device unless ``--device`` names another; without a card
the default fails. ``--reduced`` runs the same launcher with the smoke-scale
config (``ArchConfig.reduced()``); without it the config's full width and
depth train on the card. A multi-host launch (``--coordinator``: one
process group across hosts, data parallelism through ``Trainer``) is not
ported yet (ROADMAP Queue 1, item 15); the rank layouts it would run on
are ``launch/mesh.py``'s.
"""
from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--variant", default="")
    p.add_argument("--reduced", action="store_true",
                   help="smoke-scale same-family config (CPU-sized)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--device", default="cuda")
    p.add_argument("--coordinator", default="",
                   help="multi-host training: not ported yet, raises")
    args = p.parse_args(argv)

    if args.coordinator:
        raise SystemExit("--coordinator: multi-host training (one process "
                         "group across hosts, data parallelism through "
                         "Trainer) is not ported yet (ROADMAP Queue 1, "
                         "item 15)")
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime.train_loop import TrainConfig, Trainer

    cfg = get_config(args.arch)
    if args.variant:
        from repro_torch.configs.opt_variants import apply_variant

        cfg = apply_variant(cfg, args.variant)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), capacity_factor=8.0)

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch))
    tc = TrainConfig(
        total_steps=args.steps, microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir or None, ckpt_every=args.ckpt_every,
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      decay_steps=args.steps))
    trainer = Trainer(cfg, tc, dataset=data, device=args.device)
    out = trainer.run()
    print(f"[train] arch={cfg.name} steps={out['steps_run']} "
          f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} "
          f"restarts={out['restarts']}")
    return out


if __name__ == "__main__":
    main()
