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
* LM parameters: the reference's stacked tree -> the port's state dict
  (a decoder-only LM's ``layers``; an encoder-decoder's ``enc_layers``,
  ``enc_ln_post`` and ``dec_layers``);
* LM caches: the stacked cache tree (an encoder-decoder's cross caches
  ``xk``/``xv`` too), both directions;
* train states: the reference's ``{"params", "opt", "step"}`` tree (layer
  leaves stacked over layers) and the port's (one tensor per leaf per
  layer), both directions, every dtype kept.
"""
from __future__ import annotations

import re
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


# the reference's stacked groups of layers and the config field that
# counts each
STACKS = {"layers": "n_layers", "enc_layers": "enc_layers",
          "dec_layers": "n_layers"}


def lm_params_from_jax(params_np: dict, cfg=None,
                       weight_slices: Optional[dict] = None) -> dict:
    """The reference LM's parameter tree as numpy (``embed.{tok,out,ln_f}``;
    ``layers.{ln1,ln2,attn.*,ssm.*,ffn.*}`` with a leading layer axis; an
    encoder-decoder's ``enc_layers.*`` and ``dec_layers.*`` with one and
    ``enc_ln_post`` without) -> the port's state dict (``embed.*``,
    ``layers.<i>.*``; ``enc_layers.<i>.*``, ``enc_ln_post``,
    ``dec_layers.<i>.*``) of CPU tensors. ``cfg``, when given, must agree
    on the number of layers of each stack.
    ``weight_slices`` ({leaf: tuple of slices}, ``models.moe.rank_slices``)
    cuts an MoE's ``ffn.w1``, ``w3`` and ``w2`` down to one rank's share
    of a (data, model) layout: (E, d, f) -> (E_loc, d_loc, f_loc) for w1
    and w3, (E, f, d) -> (E_loc, f_loc, d_loc) for w2."""
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    return lm_params_from_leaves(walk(params_np, ()), cfg,
                                 weight_slices=weight_slices)


def lm_params_from_leaves(leaves, cfg=None, *,
                          weight_slices: Optional[dict] = None,
                          device="cpu") -> dict:
    """:func:`lm_params_from_jax` of the tree's leaves ``(path, numpy
    array)`` (``models.layers.numpy_param_leaves``), each moved to
    ``device`` before the next is read."""
    cut = weight_slices or {}
    out = {}
    for path, x in leaves:
        group, name = path[0], ".".join(path[1:])
        if group not in STACKS:
            out[".".join(path)] = _tensor(x, device)
            continue
        want = None if cfg is None else getattr(cfg, STACKS[group])
        if want is not None and want != x.shape[0]:
            raise ValueError(f"tree has {x.shape[0]} {group}, config "
                             f"{want}")
        for i in range(x.shape[0]):
            out[f"{group}.{i}.{name}"] = _tensor(
                x[i][cut[path[-1]]] if path[-2:-1] == ("ffn",)
                and path[-1] in cut else x[i],
                device)
    return out


def lm_cache_from_jax(cache_np: dict, device="cpu") -> dict:
    """The reference's stacked LM cache (numpy leaves ``k``, ``v``,
    ``slot_pos``, ``conv``, ``ssm``; an encoder-decoder's ``xk``, ``xv``;
    each with a leading layer axis) -> the port's cache on ``device``;
    every dtype is kept."""
    return {k: _tensor(v, device) for k, v in cache_np.items()}


def lm_cache_to_jax(cache: dict) -> dict:
    """The port's stacked LM cache -> numpy arrays in the reference's
    layout and dtypes (bfloat16 leaves as float32)."""
    out = {}
    for k, v in cache.items():
        v = v.detach().cpu()
        out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return out


_LAYER = re.compile(r"^(layers|enc_layers|dec_layers)\.(\d+)\.(.+)$")


def stack_layers(flat: dict) -> dict:
    """{``layers.<i>.x``: tensor} -> {``layers.x``: tensors stacked over
    i}, and so for an encoder-decoder's ``enc_layers`` and ``dec_layers``;
    any other key is kept as it is. The reference's layout."""
    out, layered = {}, {}
    for k, v in flat.items():
        m = _LAYER.match(k)
        if m:
            layered.setdefault((m.group(1), m.group(3)), {})[
                int(m.group(2))] = v
        else:
            out[k] = v
    for (group, rest), by_layer in layered.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{group} of {rest!r}: {sorted(by_layer)}")
        out[f"{group}.{rest}"] = torch.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return out


def nest(flat: dict) -> dict:
    """{``a.b.c``: leaf} -> {"a": {"b": {"c": leaf}}}."""
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nest`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def train_state_to_jax(state: dict) -> dict:
    """The port's train state (``params`` and each per-parameter entry of
    ``opt`` keyed ``embed.*`` / ``layers.<i>.*``; an optimizer entry keyed
    by a stacked leaf name, adafactor_m's ``vr``/``vc``, as it is;
    ``step`` an int) -> the reference's tree layout, layer leaves stacked.
    Leaves stay tensors on their device in their dtypes; the step is an
    int32 numpy scalar, as the reference saves it."""
    return {"params": nest(stack_layers(state["params"])),
            "opt": {k: nest(stack_layers(v)) for k, v in state["opt"].items()},
            "step": np.asarray(int(state["step"]), np.int32)}


def _unstack(node, device) -> dict:
    """A nested reference subtree (numpy or tensor leaves) -> {port name:
    tensor}, each stacked ``layers.*`` leaf cut per layer."""
    out = {}
    for k, x in flatten(node).items():
        t = x if isinstance(x, torch.Tensor) else _tensor(x)
        t = t.to(device)
        group, _, rest = k.partition(".")
        if group in STACKS:
            for i in range(t.shape[0]):
                out[f"{group}.{i}.{rest}"] = t[i].clone()
        else:
            out[k] = t
    return out


# adafactor_m's factored moments, which the port keeps per stacked leaf
_STACKED_OPT = ("vr", "vc")


def train_state_from_jax(state_np: dict, device="cpu") -> dict:
    """The reference's train state ``{"params", "opt", "step"}`` (numpy or
    tensor leaves, layer leaves stacked; e.g. a JAX train state through
    ``jax.tree.map(np.asarray, ...)`` or ``checkpoint.restore``) -> the
    port's, on ``device``. adafactor_m's ``vr``/``vc`` keep the stacked
    layout, keyed by the stacked leaf name."""
    opt = {}
    for k, v in state_np["opt"].items():
        if k in _STACKED_OPT:
            opt[k] = {n: (x if isinstance(x, torch.Tensor) else _tensor(x))
                      .to(device) for n, x in flatten(v).items()}
        else:
            opt[k] = _unstack(v, device)
    return {"params": _unstack(state_np["params"], device), "opt": opt,
            "step": int(np.asarray(state_np["step"]))}
