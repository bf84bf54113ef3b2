"""Public model API of the port: build an LM from an ``ArchConfig``, and
the abstract inputs and their layout specs the dry run counts a step on.

Mirrors ``repro/models/api.py``. ``build_model``: an encoder-decoder
config (``cfg.is_encdec``: the audio family) builds ``models/encdec.py::
EncDecLM``, every other family (dense, moe, vlm, hybrid, ssm)
``models/transformer.py::DecoderLM``. ``batch_shapes`` and
``decode_inputs`` give meta tensors (shapes and types, no memory);
``batch_specs`` and the decode specs give, per dimension, the layout axes
that split it (``None``: whole), per the port's ``AxisRules``: the batch
over the data-parallel axes, a sequence-sharded config's tokens over the
TP axis. The port keeps every layer but the MoE's expert leaves whole on
each rank, so a decode cache splits only its batch (the reference also
splits its sequence over ``kv_seq``). ``local_shape`` is one rank's share.
"""
from __future__ import annotations

import torch

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import FAMILIES, DecoderLM


def build_model(cfg, device="cuda", dtype=None, core: str = "kernel",
                groups=None, rules=None):
    """The LM for ``cfg`` on ``device`` with placeholder parameters in
    ``dtype`` (default ``cfg.param_dtype``); load them with
    ``model.load_params``. ``core="plain"`` routes kernels 6 and 7 to
    their plain versions, so ``chip_smoke.py`` can compare the two on the
    card; the model's ``core`` attribute may be switched later. With
    ``torch.distributed`` ``groups`` (``layers.RankGroups``) and the
    layout's ``rules`` (default: the host layout of the groups' sizes) it
    is one rank of a (data, model) layout: its batch is the rank's data
    shard, and an MoE holds its share of the expert leaves
    (``moe.rank_slices``, which ``convert.lm_params_from_jax(...,
    weight_slices=...)`` applies). The encoder-decoder takes no groups."""
    if cfg.is_encdec:
        if groups is not None:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder runs on one device")
        return EncDecLM(cfg, device=device, dtype=dtype, core=core)
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port builds the "
            f"{'/'.join(FAMILIES)} families and encoder-decoders")
    return DecoderLM(cfg, device=device, dtype=dtype, core=core,
                     groups=groups, rules=rules)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_shapes(cfg, shape) -> dict:
    """A train/prefill batch of ``shape`` (``configs.base.ShapeConfig``) as
    meta tensors: ``tokens`` and ``labels`` (B, S) int32; a VLM's
    ``patches`` (B, P, d) and S - P tokens, an encoder-decoder's
    ``frames`` (B, F, d), in the compute type."""
    B, S = shape.global_batch, shape.seq_len
    cdt = getattr(torch, cfg.compute_dtype)
    tok = lambda n: _meta((B, n), torch.int32)  # noqa: E731
    if cfg.family == "vlm":
        P = cfg.n_frontend_tokens
        return {"patches": _meta((B, P, cfg.d_model), cdt),
                "tokens": tok(S - P), "labels": tok(S - P)}
    if cfg.family == "audio":
        F = cfg.n_frontend_tokens
        return {"frames": _meta((B, F, cfg.d_model), cdt),
                "tokens": tok(S), "labels": tok(S)}
    return {"tokens": tok(S), "labels": tok(S)}


def batch_specs(cfg, rules, batch_size: int) -> dict:
    """Per batch entry, the layout axes splitting each dimension: the
    batch over ``rules.dp`` when it divides, a ``seq_shard`` config's
    tokens over the TP axis."""
    bspec = rules.dp_if(batch_size)
    sp = rules.tp if cfg.seq_shard else None
    out = {"tokens": (bspec, sp), "labels": (bspec, sp)}
    if cfg.family == "vlm":
        out["patches"] = (bspec, None, None)
    if cfg.family == "audio":
        out["frames"] = (bspec, None, None)
    return out


def decode_inputs(cfg, shape, model, rules=None):
    """((cache, tokens, pos), (cache specs, token spec, pos spec)) of a
    decode cell: the stacked (L, B, ...) cache of ``shape``'s batch and
    length and the (B, 1) int32 tokens as meta tensors, ``pos`` the last
    position (an int; the step's work does not depend on it). ``rules``
    default to the model's."""
    B, S = shape.global_batch, shape.seq_len
    rules = rules or getattr(model, "rules", None)
    cache = {k: _meta(s, dt) for k, (s, dt) in model.cache_shapes(B, S)
             .items()}
    tokens = _meta((B, 1), torch.int32)
    bspec = rules.dp_if(B) if rules is not None else None
    cache_specs = {k: (None,) * v.dim() if k == "slot_pos"
                   else (None, bspec) + (None,) * (v.dim() - 2)
                   for k, v in cache.items()}
    return (cache, tokens, S - 1), (cache_specs, (bspec, None), ())


def local_shape(shape, spec, rules) -> tuple:
    """One rank's share of a tensor of ``shape`` split by ``spec``."""
    out = []
    for n, axes in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        k = rules.axis_size(axes) if rules is not None else 1
        if n % k:
            raise ValueError(f"dimension {n} does not split {k} ways")
        out.append(n // k)
    return tuple(out)
