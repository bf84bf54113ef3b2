"""falcon-mamba-7b — attention-free mamba-1. [arXiv:2410.05355; unverified]

Attention-free: the paper's attention-side congestion patterns are
inapplicable (DESIGN.md §6); O(1) decode state makes ``long_500k`` runnable.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    d_inner=8192,
    conv_width=4,
    long_context_ok=True,
    source="arXiv:2410.05355; unverified",
)
