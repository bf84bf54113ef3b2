"""Device dispatch for the kernels.

A CPU tensor goes to the plain PyTorch version (``ref``). A CUDA tensor
goes to the hand-written kernel, or to the plain version when the caller
asks for ``core="plain"`` (only to compare the two on the card); the
kernel raises on what it does not take, with no fallback.
"""
from __future__ import annotations

from repro_torch.kernels import fabric_step as _fs
from repro_torch.kernels import ref

CORES = ("kernel", "plain")
pack_scalars = _fs.pack_scalars


def fabric_step_core(*args, core: str = "kernel", scalars=None, **kw):
    """Fused fabric-simulator step core; same signature and return dict
    as :func:`repro_torch.kernels.ref.fabric_step_core`. ``scalars`` is
    the kernel's packed (B, 5) block of the five scalar arguments
    (:func:`pack_scalars`); the plain version reads the arguments."""
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, got {core!r}")
    device = args[1].device  # inject
    if device.type == "cpu" or core == "plain":
        return ref.fabric_step_core(*args, **kw)
    if device.type != "cuda":
        raise ValueError(f"no fabric_step_core for device {device}")
    return _fs.fabric_step_core(*args, scalars=scalars, **kw)
