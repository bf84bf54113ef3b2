"""whisper-tiny — encoder-decoder audio backbone. [arXiv:2212.04356]

Conv audio frontend is a stub per the brief: ``input_specs()`` supplies
precomputed frame embeddings (B, 1500, 384). The assigned shapes apply to the
decoder token stream (stress-lowering configs; Whisper's real max is 448 —
noted in DESIGN.md). 6 heads do not divide 16-way TP: heads replicated.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    enc_layers=4,
    n_frontend_tokens=1500,
    source="arXiv:2212.04356; unverified",
)
