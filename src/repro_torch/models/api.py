"""Public model API of the port: build an LM from an ``ArchConfig``.

Mirrors ``repro/models/api.py::build_model`` for the families this port
serves (dense, hybrid, ssm). The MoE, VLM and audio/encoder-decoder
families are not ported yet (ROADMAP Queue 1, item 14).
"""
from __future__ import annotations

from repro_torch.models.transformer import FAMILIES, DecoderLM


def build_model(cfg, device="cuda", dtype=None,
                core: str = "kernel") -> DecoderLM:
    """The LM for ``cfg`` on ``device`` with uninitialised parameters in
    ``dtype`` (default ``cfg.param_dtype``); load them with
    ``model.load_params``. ``core="plain"`` routes kernels 6 and 7 to
    their plain versions, so ``chip_smoke.py`` can compare the two on the
    card; the model's ``core`` attribute may be switched later."""
    if cfg.is_encdec or cfg.n_experts or cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): the port serves the "
            f"{'/'.join(FAMILIES)} families; MoE, VLM and audio models wait "
            "for ROADMAP Queue 1, item 14")
    return DecoderLM(cfg, device=device, dtype=dtype, core=core)
