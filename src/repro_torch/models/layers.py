"""Model-layer machinery of the port: parameter declarations and their two
initialisers, norms, RoPE, decode attention over a KV cache, MLP,
embedding, unembedding and the token cross-entropy.

Mirrors ``repro/models/layers.py``: the declarations keep the reference's
shapes, ``init`` and ``std`` but carry no sharding spec. ``AxisRules``
maps the parallel roles onto the axes of a rank layout
(``launch.mesh.rules_for``); the reference's sharding constraints have no
counterpart, since the port keeps every layer but the MoE's expert leaves
whole on each rank. Prefill attention is kernel 7
(``kernels.ops.flash_attention``), called from ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

# --------------------------------------------------------------------------
# Axis rules
# --------------------------------------------------------------------------


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Maps logical parallelism roles onto layout axis names, as the
    reference's ``AxisRules`` (``repro/models/layers.py:38``)."""

    dp: tuple  # batch axes, e.g. ("pod", "data") or ("data",)
    fsdp: tuple  # weight input-dim sharding axes
    tp: Optional[str]  # tensor-parallel axis ("model")
    ep: tuple  # expert-parallel axes (the MoE's all-to-all group)
    kv_seq: Optional[str]  # axis of a decode KV cache's sequence split
    sizes: Mapping[str, int]  # layout axis name -> size

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        return _prod(self.sizes[a] for a in axes)

    @property
    def dp_size(self) -> int:
        return self.axis_size(self.dp)

    @property
    def ep_size(self) -> int:
        return self.axis_size(self.ep)

    @property
    def tp_size(self) -> int:
        return self.axis_size(self.tp) if self.tp else 1

    def tp_if(self, n: int):
        """TP axis if ``n`` divides evenly, else None (whole)."""
        return self.tp if (self.tp and n % self.sizes[self.tp] == 0) else None

    def fsdp_if(self, n: int):
        """FSDP axes if ``n`` divides evenly, else None."""
        if self.fsdp and n % self.axis_size(self.fsdp) == 0:
            return self.fsdp
        return None

    def dp_if(self, n: int):
        if self.dp and n % self.dp_size == 0:
            return self.dp
        return None


def single_device_rules(data: int = 1, model: int = 1) -> AxisRules:
    """The rules of a (data, model) host layout (1 x 1: one device)."""
    return AxisRules(dp=("data",), fsdp=("data",), tp="model", ep=("data",),
                     kv_seq="model", sizes={"data": data, "model": model})


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """The process groups of one rank for the rules' roles: ``dp`` (the
    batch's ranks, over which losses and aux losses are averaged), ``ep``
    (the expert-parallel and FSDP ranks: the rules' ``ep`` axes) and
    ``tp`` (the tensor-parallel ranks). ``None`` is a group of one."""

    dp: Any = None
    ep: Any = None
    tp: Any = None


class ParamDecl(NamedTuple):
    shape: tuple
    init: str = "normal"  # "normal" | "ones" | "zeros"
    std: float = 0.02


def mlp_decls(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    decls = {"w1": ParamDecl((d, f)), "w2": ParamDecl((f, d), std=out_std)}
    if cfg.act == "swiglu":
        decls["w3"] = ParamDecl((d, f))
    return decls


def attn_decls(cfg) -> dict:
    d, H, KH, D = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                   cfg.resolved_head_dim)
    out_std = 0.02 / np.sqrt(2 * max(cfg.n_layers, 1))
    return {"wq": ParamDecl((d, H, D)), "wk": ParamDecl((d, KH, D)),
            "wv": ParamDecl((d, KH, D)),
            "wo": ParamDecl((H, D, d), std=out_std)}


def embed_decls(cfg) -> dict:
    V, d = cfg.vocab_padded, cfg.d_model
    return {"tok": ParamDecl((V, d)),
            "out": ParamDecl((d, V), std=0.02 / np.sqrt(max(cfg.n_layers, 1))),
            "ln_f": ParamDecl((d,), init="ones")}


def block_decls(cfg, rules=None) -> dict:
    """One layer's declarations, in the reference's order
    (``transformer.py:build_decoder_lm``); an MoE layer's expert leaves
    hold one rank's share under ``rules`` (``moe.expert_dims``; all of
    them without)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib

    block: dict = {"ln1": ParamDecl((cfg.d_model,), init="ones")}
    if cfg.family != "ssm":
        block["attn"] = attn_decls(cfg)
    if cfg.ssm_state > 0:
        block["ssm"] = ssm_lib.ssm_decls(cfg)
    if cfg.d_ff > 0:
        block["ln2"] = ParamDecl((cfg.d_model,), init="ones")
        block["ffn"] = (moe_lib.moe_decls(cfg, rules) if cfg.n_experts
                        else mlp_decls(cfg))
    return block


def encdec_decls(cfg) -> dict:
    """The encoder-decoder's declarations, as the reference's
    ``encdec.py:build_encdec`` (``:43-54``): ``enc_layers`` (``ln1``,
    ``attn``, ``ln2``, ``ffn``) and ``dec_layers`` (with ``lnx`` and the
    cross-attention ``xattn``) one layer each, and the single
    ``enc_ln_post``."""
    ln = lambda: ParamDecl((cfg.d_model,), init="ones")  # noqa: E731
    return {
        "enc_layers": {"ln1": ln(), "attn": attn_decls(cfg), "ln2": ln(),
                       "ffn": mlp_decls(cfg)},
        "enc_ln_post": ln(),
        "dec_layers": {"ln1": ln(), "attn": attn_decls(cfg), "lnx": ln(),
                       "xattn": attn_decls(cfg), "ln2": ln(),
                       "ffn": mlp_decls(cfg)}}


def model_decls(cfg, rules=None):
    """(group, declarations, layers) of the whole parameter tree in the
    reference's order: ``embed``, then a decoder-only LM's ``layers`` or
    an encoder-decoder's ``enc_layers``, ``enc_ln_post``, ``dec_layers``.
    A group of ``layers`` > 0 holds one layer's declarations, stacked on a
    leading layer axis; ``enc_ln_post`` is a single leaf (0)."""
    out = [("embed", embed_decls(cfg), 0)]
    if not cfg.is_encdec:
        return out + [("layers", block_decls(cfg, rules), cfg.n_layers)]
    enc = encdec_decls(cfg)
    return out + [("enc_layers", enc["enc_layers"], cfg.enc_layers),
                  ("enc_ln_post", enc["enc_ln_post"], 0),
                  ("dec_layers", enc["dec_layers"], cfg.n_layers)]


def _leaves(decls: Mapping, prefix: str = ""):
    """(dotted name, decl) of a nested declaration tree, in order."""
    for name, d in decls.items():
        if isinstance(d, Mapping):
            yield from _leaves(d, f"{prefix}{name}.")
        else:
            yield prefix + name, d


def _draw(decl: ParamDecl, shape, normal):
    if decl.init == "ones":
        return np.ones(shape, np.float32)
    if decl.init == "zeros":
        return np.zeros(shape, np.float32)
    return normal(shape) * np.float32(decl.std)


def _group_leaves(cfg):
    """(path, decl, leading layer axis or ()) of :func:`model_decls`."""
    for group, decls, n in model_decls(cfg):
        if isinstance(decls, ParamDecl):
            yield (group,), decls, ()
            continue
        for name, d in _leaves(decls):
            yield (group, *name.split(".")), d, ((n,) if n else ())


def numpy_param_leaves(cfg, seed: int):
    """(path, float32 array) of the reference's parameter tree, one leaf
    at a time in declaration order (``("embed", "tok")``, ...; layer
    leaves with a leading layer axis; an encoder-decoder's
    ``("enc_ln_post",)`` without one), drawn with
    ``np.random.default_rng(seed)``: a caller that converts each leaf as
    it comes never holds two copies of a large model."""
    rng = np.random.default_rng(seed)
    normal = lambda shape: rng.standard_normal(shape, np.float32)  # noqa: E731
    for path, d, lead in _group_leaves(cfg):
        yield path, _draw(d, lead + tuple(d.shape), normal)


def numpy_params(cfg, seed: int) -> dict:
    """The reference's parameter tree (``embed.{tok,out,ln_f}``;
    ``layers.*`` with a leading layer axis, or an encoder-decoder's
    ``enc_layers.*``, ``enc_ln_post``, ``dec_layers.*``) as float32 numpy
    arrays (:func:`numpy_param_leaves`): the same values for both packages
    in the parity tests and the reference rows."""
    out: dict = {}
    for path, x in numpy_param_leaves(cfg, seed):
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = x
    return out


def init_params(cfg, generator: torch.Generator, dtype=None,
                device="cuda") -> dict:
    """The port's state dict (``embed.*``, ``layers.<i>.*``; an
    encoder-decoder's ``enc_layers.<i>.*``, ``enc_ln_post``,
    ``dec_layers.<i>.*``) drawn from ``generator`` on ``device``,
    following each declaration's ``init`` and ``std``, in ``dtype``
    (default the config's ``param_dtype``). Normal draws are float32, then
    cast, one tensor at a time."""
    dtype = dtype or getattr(torch, cfg.param_dtype)

    def draw(d: ParamDecl):
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        x = torch.randn(d.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(d.std).to(dtype)

    out = {}
    for group, decls, n in model_decls(cfg):
        if isinstance(decls, ParamDecl):
            out[group] = draw(decls)
        elif not n:
            out.update({f"{group}.{k}": draw(d) for k, d in _leaves(decls)})
        else:
            block = list(_leaves(decls))
            for i in range(n):
                out.update({f"{group}.{i}.{k}": draw(d) for k, d in block})
    return out


# --------------------------------------------------------------------------
# Primitive layers
# --------------------------------------------------------------------------


def rms_norm(x, scale, eps: float):
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, D); positions broadcastable to
    (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mlp_apply(x, p, act: str):
    if act == "swiglu":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    elif act == "relu2":
        h = torch.square(F.relu(x @ p["w1"]))
    else:  # gelu
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     slot_pos=None):
    """Single-token attention against a KV cache.

    q: (B, H, D); caches (B, S, KH, D); ``pos`` the absolute position of
    the current token. With ``slot_pos`` (broadcastable to (B, S)) the
    cache is a ring buffer whose slot ``s`` holds position ``slot_pos[.., s]``,
    and ``window`` > 0 also drops positions ``<= pos - window``. Scores in
    float32; the probabilities are rounded to the cache's type before the
    value product, as the reference does."""
    B, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(B, KH, H // KH, D).float()
    s = torch.einsum("bkgd,bckd->bkgc", qr, k_cache.float()) * (
        1.0 / math.sqrt(D))
    if slot_pos is None:
        valid = (torch.arange(S, device=q.device) <= pos)[None, :]
    else:
        valid = slot_pos <= pos
        if window:
            valid = valid & (slot_pos > pos - window)
    valid = valid[:, None, None, :]
    s = s.masked_fill(~valid, -math.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(valid, p, 0.0)
    out = torch.einsum("bkgc,bckd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / p.sum(dim=-1, keepdim=True)
    return out.reshape(B, H, D).to(q.dtype)


def embed_tokens(emb, tokens, compute_dtype):
    # F.embedding, not emb["tok"][tokens]: the index's backward accumulates
    # repeated tokens with atomic adds on the CPU, so a replayed step would
    # not be bit-equal; the embedding's backward is deterministic.
    return F.embedding(tokens, emb["tok"]).to(compute_dtype)


def unembed(emb, x, eps: float):
    return (rms_norm(x, emb["ln_f"], eps) @ emb["out"]).float()


def token_nll(logits, labels):
    """Each token's negative log-likelihood: logits float32 (B, S, V), the
    log-sum-exp over all V (padded) columns; labels int (B, S) (the
    reference's iota-select picks the label's logit, a gather here; a
    label < 0 picks column 0)."""
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    ll = torch.gather(logits, -1,
                      labels.clamp_min(0).long()[..., None])[..., 0]
    return lse - ll


def token_xent(logits, labels, mask=None):
    """Stable masked cross-entropy, as ``repro/models/layers.py::
    token_xent``: the mean of :func:`token_nll`, ``mask`` dropping tokens
    from it (a masked label < 0 picks column 0, which the mask drops)."""
    nll = token_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
