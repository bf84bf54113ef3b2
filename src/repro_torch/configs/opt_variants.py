"""Beyond-paper optimization variants (EXPERIMENTS.md §Perf), a copy of
``repro/configs/opt_variants.py``. On one device the sharding fields
(``seq_shard``, ``moe_sharding``) change nothing; ``optimizer`` does.

``--variant opt`` on the dry-run applies these per-arch config overrides on
top of the paper-faithful baseline; results land in artifacts/dryrun_opt/.
Code-level improvements (flash-attention chunk remat W1, redundant-where
elimination, iota-select cross-entropy W5, S-shard-pinned QKV projections
K4/G5, bf16-wire MoE reductions G4) apply to the baseline path as well and
are measured step-by-step in the §Perf iteration log.

Measured deltas on the train_4k bound (single-pod, consistent accounting):
    kimi-k2:  62.6s -> 39.6s  (collective 62.6 -> 14.4s)
    grok-1:   39.6s -> 37.8s  (compute 10.7 -> 7.7s)
    phi3:     15.7s ->  7.2s  (fits HBM: 39 GB -> 9 GB)
    yi-6b:     9.5s ->  6.5s
    granite:  25.4s -> 17.5s
    internvl2:56.6s -> 41.9s
Refuted along the way (kept out): bf16 attention scores (convert
boundaries cost more than they save on the XLA path), remat="none"
(scan-residual stacking), "2d_full" full-d dispatch for grok (16x per-rank
up-projection flops).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig

# per-arch overrides for the "opt" variant
_OPT: Dict[str, dict] = {
    # K-series: full-EP MoE with sequence-sharded tokens (a2a payload
    # shrinks 16x, the fp32 TP reduce-scatter disappears); factored
    # optimizer for the 1T-param state
    "kimi-k2-1t-a32b": dict(moe_sharding="ep_sp", seq_shard=True,
                            optimizer="adafactor_m"),
    # G-series: sequence-sharded residual stream; MoE stays "2d" with the
    # (code-level) bf16-wire psums
    "grok-1-314b": dict(seq_shard=True),
    # SSM state is sequential along S — seq_shard inapplicable
    "falcon-mamba-7b": dict(),
    "hymba-1.5b": dict(),
    # enc-dec path gets its sequence-TP attention pins at code level
    "whisper-tiny": dict(),
}

# dense / vlm LMs: sequence-sharded residual stream is a pure win
# (W4-style: activations, attention traffic and qkv backward all drop)
_DEFAULT = dict(seq_shard=True)

VARIANTS = {"opt": (_OPT, _DEFAULT)}


def apply_variant(cfg: ArchConfig, variant: str) -> ArchConfig:
    per_arch, default = VARIANTS[variant]
    return dataclasses.replace(cfg, **per_arch.get(cfg.name, default))
