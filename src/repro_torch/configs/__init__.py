"""Architecture registry: ``--arch <id>`` resolves through :func:`get_config`.

A copy of ``repro.configs`` (data only), so the port needs nothing of the
JAX package to name a model.
"""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs import (
    falcon_mamba_7b,
    granite_20b,
    grok_1_314b,
    hymba_1_5b,
    internvl2_76b,
    kimi_k2_1t_a32b,
    nemotron_4_15b,
    phi3_mini_3_8b,
    whisper_tiny,
    yi_6b,
)

_ALL = (
    grok_1_314b.CONFIG,
    kimi_k2_1t_a32b.CONFIG,
    phi3_mini_3_8b.CONFIG,
    yi_6b.CONFIG,
    granite_20b.CONFIG,
    nemotron_4_15b.CONFIG,
    internvl2_76b.CONFIG,
    hymba_1_5b.CONFIG,
    whisper_tiny.CONFIG,
    falcon_mamba_7b.CONFIG,
)

REGISTRY: dict[str, ArchConfig] = {c.name: c for c in _ALL}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def all_arch_names() -> tuple[str, ...]:
    return tuple(REGISTRY)


__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "REGISTRY",
    "get_config",
    "all_arch_names",
]
