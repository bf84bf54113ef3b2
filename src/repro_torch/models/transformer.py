"""Decoder-only LM of the port for the dense, moe, vlm, hybrid and ssm
families.

Mirrors ``repro/models/transformer.py::build_decoder_lm`` as an
``nn.Module``: a stack of blocks (attention and/or Mamba heads, then an
MLP), with four entry points — ``loss`` (the training loss, as the
reference's ``loss``), ``prefill`` (prompt -> last-position logits and the
stacked cache), ``decode`` (one token at a shared position) and
``make_cache``. Prefill and training attention run through kernel 7 and
the sequence scan through kernel 6 (``kernels/ops.py``); their gradients
through the attention backward kernel and kernel 5. Decode is plain
PyTorch, as the reference computes it outside any Pallas kernel.

A VLM prepends its ``patches`` (B, n_frontend_tokens, d_model), stub
frontend embeddings as in the reference, to the embedded tokens: rope
positions run over patches and text together, so a decode step's position
counts the patches, and ``loss`` drops the patch positions before the
unembedding. An MoE layer's FFN is ``models/moe.py::moe_ffn``; ``loss``
adds the layers' load-balancing losses with the reference's weight. Given
``torch.distributed`` groups (``layers.RankGroups``: the data-parallel,
expert-parallel and tensor-parallel ranks of a layout, with its
``AxisRules``), the model is one rank's program: its batch is this rank's,
the loss is the data-parallel group's token mean, and an MoE holds this
rank's share of the expert leaves and dispatches over the groups
(``moe.moe_ffn``). Every other layer is whole on each rank.

Parameters load without gradients (serving); a trainer turns them on with
``model.requires_grad_(True)``. ``loss`` checkpoints each layer as the
reference's ``_scan_layers`` does under ``cfg.remat``: ``"full"``
recomputes the whole layer in the backward, ``"dots"`` keeps the outputs
of the matrix products without batch dimensions and recomputes the rest.

Caches are stacked over layers, ``(L, ...)``, with the reference's keys
(``k``, ``v``, ``slot_pos`` for a sliding window; ``conv``, ``ssm``), so
``convert.lm_cache_from_jax`` maps them one to one. ``decode`` writes the
new token's entries into the cache it is given, in place (the reference
returns a new tree; the serving loop drops the old one either way), and
returns that cache.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    RankGroups, block_decls, decode_attention, embed_decls, embed_tokens,
    mlp_apply, rms_norm, rope, single_device_rules, token_nll, token_xent,
    unembed,
)

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm")
RING_EMPTY = -(2 ** 30)  # slot_pos of a ring slot no token has filled
AUX_LOSS_WEIGHT = 0.01  # the reference's MoE load-balance weight
REMAT = ("full", "dots", "none")
# matrix products without batch dimensions, the ops the reference's
# ``dots_with_no_batch_dims_saveable`` policy keeps under remat="dots"
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat_layer(remat: str, block, pl, *args):
    """``block(pl, *args)``, one layer of a training forward, under the
    reference's ``_scan_layers`` policy: ``"full"`` recomputes the whole
    layer in the backward, ``"dots"`` keeps the outputs of the matrix
    products without batch dimensions and recomputes the rest. Without
    gradients it is the plain call."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return block(pl, *args)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(block, pl, *args, use_reentrant=False, **kw)


def _params(decls, dtype) -> nn.ParameterDict:
    """Placeholders of a declaration tree's parameters (nested dicts): meta
    tensors of their shapes and type, which hold no memory until
    ``load_params`` assigns the real ones (grok-1's 42.6 GB would
    otherwise sit on the card twice while a set is drawn)."""
    out = nn.ParameterDict()
    for name, d in decls.items():
        if isinstance(d, dict):
            out[name] = _params(d, dtype)
        else:
            out[name] = nn.Parameter(
                torch.empty(d.shape, dtype=dtype, device="meta"),
                requires_grad=False)
    return out


class DecoderLM(nn.Module):
    """The LM on one device. Parameters start as placeholders on the meta
    device: load them with :meth:`load_params` (``layers.init_params``
    draws a set)."""

    def __init__(self, cfg, *, device="cuda", dtype=None,
                 core: str = "kernel", groups=None, rules=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r}")
        if core not in ops.CORES:
            raise ValueError(f"core must be one of {ops.CORES}, got {core!r}")
        self.cfg = cfg
        self.core = core  # "plain" routes kernels 6 and 7 to ref.py
        self.device = torch.device(device)
        self.param_dtype = dtype or getattr(torch, cfg.param_dtype)
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        self.has_attn = cfg.family != "ssm"
        self.has_ssm = cfg.ssm_state > 0
        self.has_mlp = cfg.d_ff > 0
        self.is_moe = cfg.n_experts > 0
        self.groups = groups or RankGroups()
        if rules is None and (self.groups.ep is not None
                              or self.groups.tp is not None):
            rules = single_device_rules(
                collectives.group_size(self.groups.ep),
                collectives.group_size(self.groups.tp))
        self.rules = rules
        self.embed = _params(embed_decls(cfg), self.param_dtype)
        block = block_decls(cfg, rules)
        self.layers = nn.ModuleList(
            _params(block, self.param_dtype) for _ in range(cfg.n_layers))

    def load_params(self, state: dict) -> "DecoderLM":
        """Take ``state`` (``embed.*``, ``layers.<i>.*``; every parameter,
        each of its declared shape) as the parameters, without a copy when
        it is already on the device in the parameter type."""
        state = {k: v.to(self.device, self.param_dtype)
                 for k, v in state.items()}
        self.load_state_dict(state, strict=True, assign=True)
        for p in self.parameters():
            p.requires_grad_(False)
        return self

    # ---------------- attention ----------------
    def _attn_seq(self, pl, x, emit_cache: bool = True):
        """Sequence attention (kernel 7) and, for a prefill, the layer's KV
        cache."""
        cfg, cdt = self.cfg, self.compute_dtype
        B, S, _ = x.shape
        q = torch.einsum("bsd,dhk->bshk", x, pl["wq"].to(cdt))
        k = torch.einsum("bsd,dhk->bshk", x, pl["wk"].to(cdt))
        v = torch.einsum("bsd,dhk->bshk", x, pl["wv"].to(cdt))
        pos = torch.arange(S, device=x.device)[None]
        q, k = rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta)
        o = ops.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True,
                                window=cfg.sliding_window, core=self.core)
        out = torch.einsum("bshk,hkd->bsd", o, pl["wo"].to(cdt))
        if not emit_cache:
            return out, None
        window = cfg.sliding_window
        if not window:
            return out, {"k": k, "v": v}
        w_eff = min(window, S)
        positions = torch.arange(S - w_eff, S, device=x.device)
        slots = positions % window

        def ring(t):
            return t.new_zeros((B, window) + t.shape[2:]).index_copy_(
                1, slots, t[:, -w_eff:])

        slot_pos = torch.full((window,), RING_EMPTY, dtype=torch.int32,
                              device=x.device)
        slot_pos[slots] = positions.to(torch.int32)
        return out, {"k": ring(k), "v": ring(v), "slot_pos": slot_pos}

    def _attn_dec(self, pl, x, cache, l, pos: int):
        """One token's attention; writes its K/V into layer ``l`` of the
        stacked cache."""
        cfg, cdt = self.cfg, self.compute_dtype
        q = torch.einsum("bd,dhk->bhk", x, pl["wq"].to(cdt))
        k = torch.einsum("bd,dhk->bhk", x, pl["wk"].to(cdt))
        v = torch.einsum("bd,dhk->bhk", x, pl["wv"].to(cdt))
        posb = torch.full((1, 1), pos, device=x.device)
        q = rope(q[:, None], posb, cfg.rope_theta)[:, 0]
        k = rope(k[:, None], posb, cfg.rope_theta)[:, 0]
        window = cfg.sliding_window
        slot = pos % window if window else pos
        kc, vc = cache["k"][l], cache["v"][l]
        kc[:, slot] = k
        vc[:, slot] = v
        if window:
            sp = cache["slot_pos"][l]
            sp[slot] = pos
            o = decode_attention(q, kc, vc, pos, window=window,
                                 slot_pos=sp[None])
        else:
            o = decode_attention(q, kc, vc, pos)
        return torch.einsum("bhk,hkd->bd", o, pl["wo"].to(cdt))

    # ---------------- blocks ----------------
    def _ffn(self, pl, x):
        """The FFN sub-block's output on x (B, S, d), or (B, d) for a
        decode step, and its aux loss (None without experts)."""
        h = rms_norm(x, pl["ln2"], self.cfg.norm_eps)
        if not self.is_moe:
            return mlp_apply(h, pl["ffn"], self.cfg.act), None
        kw = {"rules": self.rules, "groups": self.groups}
        if h.dim() == 2:  # a decode step: one token a row
            f, aux = moe_lib.moe_ffn(h[:, None], pl["ffn"], self.cfg, **kw)
            return f[:, 0], aux
        return moe_lib.moe_ffn(h, pl["ffn"], self.cfg, **kw)

    def _seq_block(self, pl, x, emit_cache: bool = True):
        """(x, the layer's cache, its aux loss or None)."""
        cfg = self.cfg
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        if self.has_attn and self.has_ssm:  # hybrid: parallel heads
            ao, kv = self._attn_seq(pl["attn"], h, emit_cache)
            so, sc = ssm_lib.ssm_apply_seq(pl["ssm"], h, cfg, core=self.core)
            x = x + (ao + so) * 0.5
            cache = dict(kv, **sc) if emit_cache else None
        elif self.has_attn:
            ao, cache = self._attn_seq(pl["attn"], h, emit_cache)
            x = x + ao
        else:
            so, cache = ssm_lib.ssm_apply_seq(pl["ssm"], h, cfg,
                                              core=self.core)
            x = x + so
        aux = None
        if self.has_mlp:
            f, aux = self._ffn(pl, x)
            x = x + f
        return x, cache, aux

    def _dec_block(self, pl, x, cache, l, pos):
        cfg = self.cfg
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        if self.has_ssm:
            layer = {k: cache[k][l] for k in ("conv", "ssm")}
            so, sc = ssm_lib.ssm_apply_decode(pl["ssm"], h, layer, cfg)
            for k, val in sc.items():
                cache[k][l] = val
        if self.has_attn and self.has_ssm:
            ao = self._attn_dec(pl["attn"], h, cache, l, pos)
            x = x + (ao + so) * 0.5
        elif self.has_attn:
            x = x + self._attn_dec(pl["attn"], h, cache, l, pos)
        else:
            x = x + so
        if self.has_mlp:
            x = x + self._ffn(pl, x)[0]
        return x

    def _train_block(self, pl, x):
        x, _, aux = self._seq_block(pl, x, emit_cache=False)
        return x if aux is None else (x, aux)

    def _layer(self, pl, x):
        """One layer of the training forward under ``cfg.remat``."""
        return remat_layer(self.cfg.remat, self._train_block, pl, x)

    def _embed_in(self, batch: dict):
        """The embedded tokens, a VLM's patches before them; and the number
        of patch positions (0 for a text-only model)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = embed_tokens(self.embed, tokens, self.compute_dtype)
        if self.cfg.family != "vlm":
            return x, 0
        front = torch.as_tensor(batch["patches"], device=self.device).to(
            self.compute_dtype)
        return torch.cat([front, x], dim=1), front.shape[1]

    # ---------------- public entry points ----------------
    def loss(self, batch: dict):
        """batch ``tokens`` and ``labels`` (B, S) (a VLM's ``patches`` too)
        -> (total loss, {"loss", "aux_loss"}), as the reference's
        ``loss``: the token cross-entropy over every padded vocabulary
        column, labels < 0 masked, plus ``AUX_LOSS_WEIGHT`` times the
        layers' summed load-balancing losses (0 without experts). Under a
        group, the batch is this rank's shard and the cross-entropy the
        mean over the group's tokens."""
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        x, n_front = self._embed_in(batch)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for pl in self.layers:
            out = self._layer(pl, x)
            if self.is_moe:
                x, a = out
                aux = aux + a
            else:
                x = out
        logits = unembed(self.embed, x[:, n_front:], self.cfg.norm_eps)
        mask = labels >= 0
        if self.groups.dp is None:
            ce = token_xent(logits, labels, mask=mask)
        else:
            # the group's masked sum over its count, ranks in order
            m = mask.float()
            parts = collectives.all_gather(torch.stack(
                [(token_nll(logits, labels) * m).sum(), m.sum()]),
                self.groups.dp)
            tot = parts[0]
            for i in range(1, parts.shape[0]):
                tot = tot + parts[i]
            ce = tot[0] / tot[1].clamp_min(1.0)
        return ce + AUX_LOSS_WEIGHT * aux, {"loss": ce, "aux_loss": aux}

    @torch.no_grad()
    def prefill(self, batch: dict):
        """batch ``tokens`` (B, S) (a VLM's ``patches`` (B, P, d) too) ->
        (last-position logits (B, V_pad) float32, stacked cache over the
        P + S positions)."""
        x, _ = self._embed_in(batch)
        caches = []
        for pl in self.layers:
            x, c, _ = self._seq_block(pl, x)
            caches.append(c)
        logits = unembed(self.embed, x[:, -1], self.cfg.norm_eps)
        cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
        return logits, cache

    @torch.no_grad()
    def decode(self, cache: dict, tokens, pos: int):
        """tokens (B, 1) at absolute position ``pos`` (a VLM's counts its
        patches) -> (logits (B, V_pad) float32, cache updated in place)."""
        pos = int(pos)
        x = embed_tokens(self.embed, tokens[:, 0].to(self.device),
                         self.compute_dtype)
        for l, pl in enumerate(self.layers):
            x = self._dec_block(pl, x, cache, l, pos)
        return unembed(self.embed, x, self.cfg.norm_eps), cache

    def cache_shapes(self, batch: int, seq: int) -> dict:
        """{key: (shape, dtype)} of the stacked cache, as the reference's
        ``cache_shapes``."""
        cfg, L = self.cfg, self.cfg.n_layers
        out = {}
        if self.has_attn:
            window = cfg.sliding_window
            s = min(seq, window) if window else seq
            kv = (L, batch, s, cfg.n_kv_heads, cfg.resolved_head_dim)
            out["k"] = (kv, self.compute_dtype)
            out["v"] = (kv, self.compute_dtype)
            if window:
                out["slot_pos"] = ((L, window), torch.int32)
        if self.has_ssm:
            for k, (shape, dt) in ssm_lib.ssm_cache_shape(
                    cfg, batch, self.compute_dtype).items():
                out[k] = ((L,) + shape, dt)
        return out

    def make_cache(self, batch: int, seq: int) -> dict:
        return {k: torch.zeros(shape, dtype=dt, device=self.device)
                for k, (shape, dt) in self.cache_shapes(batch, seq).items()}
