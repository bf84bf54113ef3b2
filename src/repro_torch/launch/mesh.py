"""Device meshes for the port's sharded sweep launcher.

PyTorch has no mesh object: a mesh here is a tuple of ``torch.device``,
one entry a shard, and a device may appear more than once (two shards on
one card run one after the other).
"""
from __future__ import annotations

from typing import Tuple

import torch


def make_sweep_mesh(n_devices: int = 0, *, device=None
                    ) -> Tuple[torch.device, ...]:
    """The flat mesh that launch/sweep.py splits an engine batch over.

    Without ``device``: the CUDA devices, or the first ``n_devices`` of
    them; without a card that is an error. With ``device``: that device
    ``n_devices`` times (at least once), e.g. two shards on the CPU or two
    on ``cuda:0``."""
    if device is not None:
        return (torch.device(device),) * max(1, int(n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_sweep_mesh takes the CUDA devices by default and none is "
            "available; pass device='cpu' for a mesh on the CPU")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    return devs[:int(n_devices)] if n_devices else devs
