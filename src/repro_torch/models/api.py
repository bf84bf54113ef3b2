"""Public model API of the port: build an LM from an ``ArchConfig``.

Mirrors ``repro/models/api.py::build_model``: an encoder-decoder config
(``cfg.is_encdec``: the audio family) builds ``models/encdec.py::
EncDecLM``, every other family (dense, moe, vlm, hybrid, ssm)
``models/transformer.py::DecoderLM``. The reference's ``batch_shapes``,
``batch_specs`` and ``decode_inputs`` are dry-run plumbing and wait for
the XLA tooling (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

from repro_torch.models.encdec import EncDecLM
from repro_torch.models.transformer import FAMILIES, DecoderLM


def build_model(cfg, device="cuda", dtype=None, core: str = "kernel",
                group=None):
    """The LM for ``cfg`` on ``device`` with placeholder parameters in
    ``dtype`` (default ``cfg.param_dtype``); load them with
    ``model.load_params``. ``core="plain"`` routes kernels 6 and 7 to
    their plain versions, so ``chip_smoke.py`` can compare the two on the
    card; the model's ``core`` attribute may be switched later. With a
    ``torch.distributed`` ``group`` the model is this rank's data-parallel
    shard, and an ``ep``/``ep_sp`` MoE holds this rank's experts
    (``convert.lm_params_from_jax(..., expert_slice=...)``); the
    encoder-decoder takes no group."""
    if cfg.is_encdec:
        if group is not None:
            raise NotImplementedError(
                f"{cfg.name}: the encoder-decoder runs on one device")
        return EncDecLM(cfg, device=device, dtype=dtype, core=core)
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port builds the "
            f"{'/'.join(FAMILIES)} families and encoder-decoders")
    return DecoderLM(cfg, device=device, dtype=dtype, core=core,
                     group=group)
