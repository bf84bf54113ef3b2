"""kimi-k2-1t-a32b — 384-expert top-8 trillion-param MoE. [arXiv:2501.kimi2]

The paper-representative cell: EP expert dispatch is an explicit all-to-all
over the data-parallel axis (the paper's AlltoAll congestion pattern).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    head_dim=112,
    act="swiglu",
    n_experts=384,
    top_k=8,
    moe_sharding="ep",
    pod_param_sharding="fsdp",
    optimizer="adafactor_m",
    source="arXiv:2501.kimi2; unverified",
)
