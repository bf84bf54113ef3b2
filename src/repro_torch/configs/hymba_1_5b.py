"""hymba-1.5b — parallel attention + mamba heads, SWA. [arXiv:2411.13676; hf]

25 heads do not divide the 16-wide TP axis: attention heads are replicated
over ``model`` (only FFN/SSM inner dims are TP-sharded). SSM state + sliding
window attention make ``long_500k`` runnable (sub-quadratic).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    head_dim=64,
    act="swiglu",
    ssm_state=16,
    d_inner=3200,
    sliding_window=1024,
    long_context_ok=True,
    source="arXiv:2411.13676; hf",
)
