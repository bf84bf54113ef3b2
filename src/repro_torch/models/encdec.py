"""Encoder-decoder LM of the port (the ``audio`` family: whisper-tiny).

Mirrors ``repro/models/encdec.py::build_encdec`` as an ``nn.Module``. The
audio conv frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``frames`` (B, n_frontend_tokens, d_model).
Both stacks add a sinusoidal position table to their inputs (no rope).
Every sequence attention runs through kernel 7 (``kernels/ops.py``): the
encoder's and the cross-attention non-causal, the decoder's causal. Decode
is plain PyTorch, as the reference computes it outside any Pallas kernel;
its cross-attention reads every frame (``pos = F - 1``).

Caches are stacked over the decoder's layers with the reference's keys:
``k``, ``v`` (B, S, KH, D) for the self-attention and ``xk``, ``xv`` (B,
F, KH, D) for the cross-attention, so ``convert.lm_cache_from_jax`` maps
them one to one. ``decode`` writes the new token's entries into the cache
it is given, in place, and returns that cache.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.layers import (
    decode_attention, embed_decls, embed_tokens, encdec_decls, mlp_apply,
    rms_norm, token_xent, unembed,
)
from repro_torch.models.transformer import DecoderLM, _params, remat_layer


def sinusoids(length: int, channels: int, offset: int = 0, device=None):
    """Standard sin/cos positional embedding (length, channels), float32,
    in the reference's order of operations (``encdec.py:26-33``)."""
    assert channels % 2 == 0
    log_timescale = math.log(10_000.0) / (channels // 2 - 1)
    inv = torch.exp(torch.tensor(-log_timescale, dtype=torch.float32)
                    * torch.arange(channels // 2, dtype=torch.float32))
    pos = (offset + torch.arange(length))[:, None].to(torch.float32)
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(device)


class EncDecLM(nn.Module):
    """The encoder-decoder on one device. Parameters start as placeholders
    on the meta device: load them with :meth:`load_params`
    (``layers.init_params`` draws a set)."""

    def __init__(self, cfg, *, device="cuda", dtype=None,
                 core: str = "kernel"):
        super().__init__()
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder")
        if core not in ops.CORES:
            raise ValueError(f"core must be one of {ops.CORES}, got {core!r}")
        self.cfg = cfg
        self.core = core  # "plain" routes kernel 7 to ref.py
        self.device = torch.device(device)
        self.param_dtype = dtype or getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        decls = encdec_decls(cfg)
        self.embed = _params(embed_decls(cfg), self.param_dtype)
        self.enc_layers = nn.ModuleList(
            _params(decls["enc_layers"], self.param_dtype)
            for _ in range(cfg.enc_layers))
        self.enc_ln_post = nn.Parameter(torch.empty(
            decls["enc_ln_post"].shape, dtype=self.param_dtype,
            device="meta"), requires_grad=False)
        self.dec_layers = nn.ModuleList(
            _params(decls["dec_layers"], self.param_dtype)
            for _ in range(cfg.n_layers))

    load_params = DecoderLM.load_params

    # ---------------- blocks ----------------
    def _attn(self, pl, xq, xkv, causal: bool):
        """Attention of xq over xkv (kernel 7), projected out; and its K/V."""
        cdt = self.compute_dtype
        q = torch.einsum("bsd,dhk->bshk", xq, pl["wq"].to(cdt))
        k = torch.einsum("bsd,dhk->bshk", xkv, pl["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", xkv, pl["wv"].to(cdt))
        o = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=causal,
                                core=self.core)
        return torch.einsum("bshk,hkd->bsd", o, pl["wo"].to(cdt)), (k, v)

    def _ffn(self, pl, x):
        return mlp_apply(rms_norm(x, pl["ln2"], self.cfg.norm_eps),
                         pl["ffn"], self.cfg.act)

    def _enc_block(self, pl, x):
        h = rms_norm(x, pl["ln1"], self.cfg.norm_eps)
        x = x + self._attn(pl["attn"], h, h, causal=False)[0]
        return x + self._ffn(pl, x)

    def _dec_block(self, pl, x, enc_out, emit_cache: bool = True):
        eps = self.cfg.norm_eps
        h = rms_norm(x, pl["ln1"], eps)
        ao, (k, v) = self._attn(pl["attn"], h, h, causal=True)
        x = x + ao
        xo, (xk, xv) = self._attn(pl["xattn"], rms_norm(x, pl["lnx"], eps),
                                  enc_out, causal=False)
        x = x + xo
        x = x + self._ffn(pl, x)
        if not emit_cache:
            return x
        return x, {"k": k, "v": v, "xk": xk, "xv": xv}

    def encode(self, frames):
        """frames (B, F, d) -> the encoder's output, after ``enc_ln_post``;
        each layer under ``cfg.remat`` when gradients are on."""
        cfg, cdt = self.cfg, self.compute_dtype
        x = torch.as_tensor(frames, device=self.device).to(cdt) + sinusoids(
            cfg.n_frontend_tokens, cfg.d_model, device=self.device).to(
                cdt)[None]
        for pl in self.enc_layers:
            x = remat_layer(cfg.remat, self._enc_block, pl, x)
        return rms_norm(x, self.enc_ln_post, cfg.norm_eps)

    def _dec_in(self, tokens):
        cfg, cdt = self.cfg, self.compute_dtype
        x = embed_tokens(self.embed, tokens, cdt)
        return x + sinusoids(tokens.shape[1], cfg.d_model,
                             device=self.device).to(cdt)[None]

    # ---------------- public entry points ----------------
    def loss(self, batch: dict):
        """batch ``frames`` (B, F, d), ``tokens`` and ``labels`` (B, S) ->
        (loss, {"loss", "aux_loss"}), as the reference's ``loss``: the
        token cross-entropy over every padded vocabulary column, labels <
        0 masked; the aux loss is 0."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        enc_out = self.encode(batch["frames"])
        x = self._dec_in(tokens)
        for pl in self.dec_layers:
            x = remat_layer(self.cfg.remat, self._dec_block, pl, x, enc_out,
                            False)
        logits = unembed(self.embed, x, self.cfg.norm_eps)
        ce = token_xent(logits, labels, mask=labels >= 0)
        return ce, {"loss": ce,
                    "aux_loss": torch.zeros((), dtype=torch.float32,
                                            device=self.device)}

    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch ``frames`` (B, F, d) and ``tokens`` (B, S) ->
        (last-position logits (B, V_pad) float32, stacked cache)."""
        enc_out = self.encode(batch["frames"])
        x = self._dec_in(torch.as_tensor(batch["tokens"],
                                         device=self.device).long())
        caches = []
        for pl in self.dec_layers:
            x, c = self._dec_block(pl, x, enc_out)
            caches.append(c)
        logits = unembed(self.embed, x[:, -1], self.cfg.norm_eps)
        return logits, {k: torch.stack([c[k] for c in caches])
                        for k in caches[0]}

    @torch.no_grad()
    def decode(self, cache: dict, tokens, pos: int):
        """tokens (B, 1) at absolute position ``pos`` -> (logits (B, V_pad)
        float32, cache updated in place)."""
        cfg, cdt = self.cfg, self.compute_dtype
        pos, eps = int(pos), cfg.norm_eps
        F = cfg.n_frontend_tokens
        x = embed_tokens(self.embed, tokens[:, 0].to(self.device), cdt)
        x = x + sinusoids(1, cfg.d_model, offset=pos,
                          device=self.device).to(cdt)[0]
        for l, pl in enumerate(self.dec_layers):
            at, xat = pl["attn"], pl["xattn"]
            h = rms_norm(x, pl["ln1"], eps)
            q = torch.einsum("bd,dhk->bhk", h, at["wq"].to(cdt))
            kc, vc = cache["k"][l], cache["v"][l]
            kc[:, pos] = torch.einsum("bd,dhk->bhk", h, at["wk"].to(cdt))
            vc[:, pos] = torch.einsum("bd,dhk->bhk", h, at["wv"].to(cdt))
            o = decode_attention(q, kc, vc, pos)
            x = x + torch.einsum("bhk,hkd->bd", o, at["wo"].to(cdt))
            qx = torch.einsum("bd,dhk->bhk", rms_norm(x, pl["lnx"], eps),
                              xat["wq"].to(cdt))
            ox = decode_attention(qx, cache["xk"][l], cache["xv"][l], F - 1)
            x = x + torch.einsum("bhk,hkd->bd", ox, xat["wo"].to(cdt))
            x = x + self._ffn(pl, x)
        return unembed(self.embed, x, eps), cache

    def cache_shapes(self, batch: int, seq: int) -> dict:
        """{key: (shape, dtype)} of the stacked cache, as the reference's
        ``cache_shapes``."""
        cfg = self.cfg
        L, KH, D = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        kv = ((L, batch, seq, KH, D), self.compute_dtype)
        xkv = ((L, batch, cfg.n_frontend_tokens, KH, D), self.compute_dtype)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}

    def make_cache(self, batch: int, seq: int) -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in self.cache_shapes(batch, seq).items()}
