"""Public model API of the port: build an LM from an ``ArchConfig``.

Mirrors ``repro/models/api.py::build_model`` for the families this port
serves (dense, moe, hybrid, ssm). The VLM and audio/encoder-decoder
families are not ported yet (ROADMAP Queue 1, item 14).
"""
from __future__ import annotations

from repro_torch.models.transformer import FAMILIES, DecoderLM


def build_model(cfg, device="cuda", dtype=None, core: str = "kernel",
                group=None) -> DecoderLM:
    """The LM for ``cfg`` on ``device`` with placeholder parameters in
    ``dtype`` (default ``cfg.param_dtype``); load them with
    ``model.load_params``. ``core="plain"`` routes kernels 6 and 7 to
    their plain versions, so ``chip_smoke.py`` can compare the two on the
    card; the model's ``core`` attribute may be switched later. With a
    ``torch.distributed`` ``group`` the model is this rank's data-parallel
    shard, and an ``ep``/``ep_sp`` MoE holds this rank's experts
    (``convert.lm_params_from_jax(..., expert_slice=...)``)."""
    if cfg.is_encdec or cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port serves the "
            f"{'/'.join(FAMILIES)} families; VLM and audio models wait "
            "for ROADMAP Queue 1, item 14")
    return DecoderLM(cfg, device=device, dtype=dtype, core=core,
                     group=group)
