"""Architecture and input-shape configuration for the repro framework.

Every assigned architecture is expressed as an :class:`ArchConfig`.  The full
configs are exercised only through the multi-pod dry-run (abstract lowering —
no allocation); smoke tests use :meth:`ArchConfig.reduced`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Shapes
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len x global_batch) and which step it lowers."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------
# Architectures
# --------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "swiglu"  # swiglu | relu2 | gelu
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_sharding: str = "ep"  # "ep" (experts over dp, all-to-all) | "2d" (TP)
    capacity_factor: float = 1.25
    # --- SSM (mamba / hybrid) ---
    ssm_state: int = 0
    d_inner: int = 0  # 0 -> 2*d_model when ssm is used
    conv_width: int = 4
    dt_rank: int = 0  # 0 -> ceil(d_model/16)
    # --- hybrid ---
    sliding_window: int = 0  # >0: SWA attention (enables long-context decode)
    # --- frontends (stubs per the brief) ---
    n_frontend_tokens: int = 0  # vlm patches / audio frames
    enc_layers: int = 0  # >0: encoder-decoder (whisper)
    # --- system knobs ---
    long_context_ok: bool = False  # whether long_500k applies
    pod_param_sharding: str = "replicate"  # "replicate" | "fsdp"
    optimizer: str = "adamw"  # "adamw" | "adafactor_m"
    remat: str = "full"  # "full" | "dots" | "none"
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_chunk: int = 1024  # KV chunk for the blockwise (flash) attention path
    score_dtype: str = "float32"  # attention score/probability dtype
    seq_shard: bool = False  # sequence-sharded residual stream (SP)
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.n_heads, 1)

    @property
    def resolved_d_inner(self) -> int:
        if self.ssm_state == 0:
            return 0
        return self.d_inner or 2 * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        if self.ssm_state == 0:
            return 0
        return self.dt_rank or _round_up(self.d_model // 16, 16)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 so it shards over 16-way TP."""
        return _round_up(self.vocab_size, 256)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    def shapes(self) -> Tuple[ShapeConfig, ...]:
        """The shape cells that apply to this architecture.

        ``long_500k`` is skipped for pure full-attention archs per the brief
        (sub-quadratic attention is not part of those archs' definitions);
        the skip list is documented in DESIGN.md §6.
        """
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.long_context_ok:
            out.append(SHAPES["long_500k"])
        return tuple(out)

    def all_cells(self) -> Tuple[Tuple[str, str], ...]:
        """(arch, shape) pairs including documented skips."""
        return tuple((self.name, s.name) for s in SHAPES.values())

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_padded * d * (1 if self.family == "ssm" else 2)
        per_layer = 0
        if self.family != "ssm":
            # attention (q, k, v, o)
            per_layer += d * self.n_heads * hd * 2  # q + o
            per_layer += d * self.n_kv_heads * hd * 2  # k + v
        if self.n_experts:
            per_layer += d * self.n_experts  # router
            per_layer += self.n_experts * 3 * d * self.d_ff
        elif self.d_ff:
            n_mats = 3 if self.act == "swiglu" else 2
            per_layer += n_mats * d * self.d_ff
        if self.ssm_state:
            di, r, n = self.resolved_d_inner, self.resolved_dt_rank, self.ssm_state
            per_layer += d * 2 * di  # in_proj (x, z)
            per_layer += di * self.conv_width  # conv
            per_layer += di * (r + 2 * n)  # x_proj
            per_layer += r * di + di  # dt_proj
            per_layer += di * n + di  # A_log, D
            per_layer += di * d  # out_proj
        total = emb + self.n_layers * per_layer
        if self.is_encdec:
            # encoder layers (full attn + mlp) + decoder cross-attention
            enc_layer = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            enc_layer += (3 if self.act == "swiglu" else 2) * d * self.d_ff
            cross = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
            total += self.enc_layers * enc_layer + self.n_layers * cross
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe = self.n_layers * self.n_experts * 3 * self.d_model * self.d_ff
        active = self.n_layers * self.top_k * 3 * self.d_model * self.d_ff
        return full - moe + active

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        return dataclasses.replace(
            self,
            n_layers=2,
            enc_layers=min(self.enc_layers, 2),
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 8),
            d_inner=128 if self.ssm_state else 0,
            dt_rank=8 if self.ssm_state else 0,
            sliding_window=min(self.sliding_window, 32),
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            remat="none",
            param_dtype="float32",
            compute_dtype="float32",
            attn_chunk=16,
        )
