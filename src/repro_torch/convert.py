"""Carry a simulator cell between the JAX package and this port.

The JAX package's ``FabricGeometry``, ``SimParams`` and step state are
pytrees of arrays; these functions take them as dicts of numpy arrays
(plus the geometry's meta ints), so the port never imports the JAX
package. A caller holding JAX objects converts with
``{k: np.asarray(v) for k, v in ...}``.

* geometry: one shared geometry, numpy (field -> array) -> FabricGeometry;
* params: one cell (no batch axis) or a stack of cells -> a stacked
  SimParams;
* state: a stacked step state, both directions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.fabric.simulator import (GEOMETRY_FIELDS, PARAM_FIELDS,
                                               FabricGeometry, SimParams)

# state key -> dtype in the port (JAX keeps ph/it/rc as int32)
STATE_FIELDS = {
    "c": torch.float32, "rem": torch.float32, "q": torch.float32,
    "arr": torch.float32, "thresh": torch.float32,
    "last_dec": torch.float32, "rc": torch.int64, "idle": torch.float32,
    "fbytes": torch.float32, "ph": torch.int64, "gap": torch.float32,
    "it": torch.int64, "t_done": torch.float32, "qd_acc": torch.float32,
    "t": torch.float32,
}


def geometry_from_numpy(arrays: dict, *, L: int, n_sw: int, n_src: int,
                        n_jobs: int, intra_node: int = 0,
                        device="cpu") -> FabricGeometry:
    """The reference's FabricGeometry fields (``GEOMETRY_FIELDS``) and meta
    ints -> the port's geometry on ``device``."""
    missing = set(GEOMETRY_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"geometry arrays missing {sorted(missing)}")
    return FabricGeometry.from_numpy(arrays, L=L, n_sw=n_sw, n_src=n_src,
                                     n_jobs=n_jobs, intra_node=intra_node,
                                     device=device)


def params_from_numpy(arrays: dict, *, batched: bool = False,
                      device="cpu") -> SimParams:
    """The reference's SimParams fields -> a stacked SimParams. One cell
    (``batched=False``) gains a leading cell axis of 1."""
    arrays = {k: (None if arrays.get(k) is None else
                  np.asarray(arrays[k]) if batched
                  else np.asarray(arrays[k])[None])
              for k in PARAM_FIELDS}
    return SimParams.from_numpy(arrays, device=device)


def state_from_numpy(arrays: dict, *, batched: bool = False,
                     device="cpu") -> dict:
    """A reference step state (one cell, or stacked) -> the port's stacked
    state."""
    out = {}
    for k, dt in STATE_FIELDS.items():
        x = np.array(arrays[k])
        out[k] = torch.as_tensor(x if batched else x[None], dtype=dt,
                                 device=device)
    return out


def state_to_numpy(state: dict, *, cell: Optional[int] = None) -> dict:
    """The port's state -> numpy arrays in the reference's dtypes (int32
    counters); ``cell`` picks one cell and drops the batch axis."""
    out = {}
    for k, v in state.items():
        x = v.detach().cpu().numpy()
        if x.dtype == np.int64:
            x = x.astype(np.int32)
        out[k] = x if cell is None else x[cell]
    return out
