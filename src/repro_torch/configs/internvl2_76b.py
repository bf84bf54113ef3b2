"""internvl2-76b — InternViT + InternLM2 VLM. [arXiv:2404.16821; unverified]

Backbone only per the brief: the ViT frontend is a stub; ``input_specs()``
supplies precomputed patch embeddings prepended to the token stream.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    act="swiglu",
    n_frontend_tokens=256,
    pod_param_sharding="fsdp",
    optimizer="adafactor_m",
    source="arXiv:2404.16821; unverified",
)
