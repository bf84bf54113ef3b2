"""Carry a simulator cell between the JAX package and this port.

The JAX package's ``FabricGeometry``, ``SimParams`` and step state are
pytrees of arrays; these functions take them as dicts of numpy arrays
(plus the geometry's meta ints), so the port never imports the JAX
package. A caller holding JAX objects converts with
``{k: np.asarray(v) for k, v in ...}``.

* geometry: one shared geometry, numpy (field -> array) -> FabricGeometry;
* params: one cell (no batch axis) or a stack of cells -> a stacked
  SimParams;
* state: a stacked step state, both directions;
* LM parameters: the reference's stacked tree -> the port's state dict;
* LM caches: the stacked cache tree, both directions.
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


def _tensor(x, device="cpu") -> torch.Tensor:
    """A numpy array -> a tensor of the same dtype; numpy has no bfloat16
    of its own, so the reference's (``ml_dtypes``) goes through float32."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.as_tensor(x.astype(np.float32),
                               device=device).to(torch.bfloat16)
    return torch.as_tensor(x, device=device)


def lm_params_from_jax(params_np: dict, cfg=None) -> dict:
    """The reference LM's parameter tree as numpy (``embed.{tok,out,ln_f}``;
    ``layers.{ln1,ln2,attn.*,ssm.*,ffn.*}`` with a leading layer axis) ->
    the port's ``DecoderLM`` state dict (``embed.*``, ``layers.<i>.*``) of
    CPU tensors. ``cfg``, when given, must agree on the number of layers."""
    out = {f"embed.{k}": _tensor(v) for k, v in params_np["embed"].items()}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    leaves = list(walk(params_np["layers"], ""))
    L = leaves[0][1].shape[0]
    if cfg is not None and cfg.n_layers != L:
        raise ValueError(f"tree has {L} layers, config {cfg.n_layers}")
    for name, x in leaves:
        for i in range(L):
            out[f"layers.{i}.{name}"] = _tensor(x[i])
    return out


def lm_cache_from_jax(cache_np: dict, device="cpu") -> dict:
    """The reference's stacked LM cache (numpy leaves ``k``, ``v``,
    ``slot_pos``, ``conv``, ``ssm``, each with a leading layer axis) -> the
    port's cache on ``device``; every dtype is kept."""
    return {k: _tensor(v, device) for k, v in cache_np.items()}


def lm_cache_to_jax(cache: dict) -> dict:
    """The port's stacked LM cache -> numpy arrays in the reference's
    layout and dtypes (bfloat16 leaves as float32)."""
    out = {}
    for k, v in cache.items():
        v = v.detach().cpu()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out
