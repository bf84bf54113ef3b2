"""grok-1-314b — 8-expert top-2 MoE. [hf:xai-org/grok-1; unverified]

8 experts do not divide the 16-wide ``data`` axis, so EP all-to-all sharding is
inapplicable; experts use 2D TP (d_model->data, d_ff->model). See DESIGN.md §6.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    act="swiglu",
    n_experts=8,
    top_k=2,
    moe_sharding="2d",
    pod_param_sharding="fsdp",
    optimizer="adafactor_m",
    source="hf:xai-org/grok-1; unverified",
)
