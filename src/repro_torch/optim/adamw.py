"""Optimizers of the port: AdamW and the memory-lean ``adafactor_m`` (bf16
first moment + factored second moment), as ``repro/optim/adamw.py``.

Parameters, gradients and state are dicts of tensors keyed by the port's
parameter names (``embed.*``, ``layers.<i>.*``: one tensor per leaf per
layer). ``update(grads, state, params, step)`` computes exactly the
reference's update — the gradients clipped to the global norm, the
cosine schedule with warmup, the bias corrections, the weight decay added
to ``u`` before the learning-rate product, moments kept in
``moment_dtype`` — and writes the new parameters and state in place under
``torch.no_grad`` (the reference returns new trees; the trainer drops the
old ones either way), returning ``(params, state, grad_norm)``. The
schedule's scalars are float32, computed with numpy as the reference
computes them in float32.

``adafactor_m`` factors the second moment of each of the reference's
leaves, which stacks a layer leaf over the layers: a per-layer vector such
as ``ln1`` is an (L, d) matrix there, factored across layers. The port
keeps that: its ``vr``/``vc`` state is keyed by the stacked leaf
(``layers.ln1``), and the update stacks a leaf's layers to compute it.
The parameters stay one tensor per layer. No ``torch.optim`` optimizer is
used: their schedules and clipping differ, and none is adafactor_m.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

_LAYER = re.compile(r"^layers\.(\d+)\.(.+)$")


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # adamw moments dtype


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # -> (params, state, grad_norm)
    state_shapes: Callable[[Any], Any]


def _f32(x) -> np.float32:
    return np.float32(x)


def _schedule(cfg: OptConfig, step) -> np.float32:
    """The learning rate at ``step``, in float32 as the reference's."""
    step = _f32(int(step))
    warm = np.minimum(_f32(1.0), (step + _f32(1)) / _f32(max(cfg.warmup_steps,
                                                            1)))
    prog = np.clip((step - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.decay_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(0.5) * (_f32(1) + np.cos(_f32(np.pi) * prog))
    return _f32(cfg.lr) * warm * (_f32(0.1) + _f32(0.9) * cos)


def _bias_corrections(cfg: OptConfig, step):
    t = _f32(int(step) + 1)
    return (float(_f32(1) - _f32(cfg.b1) ** t),
            float(_f32(1) - _f32(cfg.b2) ** t))


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares."""
    total = None
    for leaf in tree.values():
        s = torch.sum(torch.square(leaf.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip_scale(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor the reference's ``_clip`` scales every gradient by; the
    updates apply it leaf by leaf, so no float32 copy of the whole
    gradient tree is held."""
    return torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)


def _zeros_like(params: dict, dtype) -> dict:
    return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for k, p in params.items()}


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def adamw(cfg: OptConfig = OptConfig()) -> Optimizer:
    mdt = getattr(torch, cfg.moment_dtype)

    def init(params):
        return {"m": _zeros_like(params, mdt), "v": _zeros_like(params, mdt)}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip)
        lr = float(_schedule(cfg, step))
        bc1, bc2 = _bias_corrections(cfg, step)
        for k, p in params.items():
            g = grads[k].float() * scale
            m, v = state["m"][k], state["v"][k]
            m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
            v_new = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
            u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() - lr * u).to(p.dtype))
            m.copy_(m_new)
            v.copy_(v_new)
        return params, state, gnorm

    def state_shapes(param_shapes):
        shapes = {k: (tuple(s), mdt) for k, (s, _) in param_shapes.items()}
        return {"m": shapes, "v": dict(shapes)}

    return Optimizer("adamw", init, update, state_shapes)


# --------------------------------------------------------------------------
# adafactor_m: bf16 momentum + factored second moment (giant configs)
# --------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _leaf_groups(names) -> dict:
    """{reference leaf name: [port names]} — ``layers.<i>.x`` of every i
    (in layer order) under ``layers.x``, any other name alone."""
    groups: dict = {}
    layered = []
    for n in names:
        m = _LAYER.match(n)
        if m:
            layered.append((int(m.group(1)), m.group(2), n))
        else:
            groups[n] = [n]
    for _, rest, n in sorted(layered):
        groups.setdefault(f"layers.{rest}", []).append(n)
    return groups


def _stacked_shape(names, shapes) -> tuple:
    s = tuple(shapes[names[0]])
    return s if len(names) == 1 and not _LAYER.match(names[0]) \
        else (len(names),) + s


def adafactor_m(cfg: OptConfig = OptConfig()) -> Optimizer:
    def factored_shapes(shape):
        if _factored(shape):
            return shape[:-1], shape[:-2] + shape[-1:]
        return shape, (1,)

    def init(params):
        shapes = {k: tuple(p.shape) for k, p in params.items()}
        dev = next(iter(params.values())).device
        vr, vc = {}, {}
        for g, names in _leaf_groups(params).items():
            r, c = factored_shapes(_stacked_shape(names, shapes))
            vr[g] = torch.zeros(r, dtype=torch.float32, device=dev)
            vc[g] = torch.zeros(c, dtype=torch.float32, device=dev)
        return {"m": _zeros_like(params, torch.bfloat16), "vr": vr, "vc": vc}

    @torch.no_grad()
    def update(grads, state, params, step):
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, cfg.grad_clip)
        lr = float(_schedule(cfg, step))
        _, bc2 = _bias_corrections(cfg, step)
        for key, names in _leaf_groups(params).items():
            stack = len(names) > 1 or bool(_LAYER.match(names[0]))

            def st(d):  # the leaf as the reference holds it, float32
                ts = [d[n].float() for n in names]
                return torch.stack(ts) if stack else ts[0]

            p = st(params)
            g = st(grads) * scale
            m = st(state["m"])
            vr, vc = state["vr"][key], state["vc"][key]
            g2 = torch.square(g) + 1e-30
            if _factored(p.shape):
                vr_new = cfg.b2 * vr + (1 - cfg.b2) * g2.mean(dim=-1)
                vc_new = cfg.b2 * vc + (1 - cfg.b2) * g2.mean(dim=-2)
                r = vr_new / torch.clamp_min(
                    vr_new.mean(dim=-1, keepdim=True), 1e-30)
                v_hat = r[..., None] * vc_new[..., None, :]
            else:
                vr_new = cfg.b2 * vr + (1 - cfg.b2) * g2
                vc_new = vc
                v_hat = vr_new
            u = g / (torch.sqrt(v_hat / bc2) + cfg.eps)
            m_new = cfg.b1 * m + (1 - cfg.b1) * u
            upd = m_new + cfg.weight_decay * p
            p_new = p - lr * upd
            for i, n in enumerate(names):
                pi, mi = (p_new[i], m_new[i]) if stack else (p_new, m_new)
                params[n].copy_(pi.to(params[n].dtype))
                state["m"][n].copy_(mi.to(torch.bfloat16))
            vr.copy_(vr_new)
            if vc_new is not vc:
                vc.copy_(vc_new)
        return params, state, gnorm

    def state_shapes(param_shapes):
        shapes = {k: tuple(s) for k, (s, _) in param_shapes.items()}
        vr, vc = {}, {}
        for g, names in _leaf_groups(shapes).items():
            r, c = factored_shapes(_stacked_shape(names, shapes))
            vr[g] = (r, torch.float32)
            vc[g] = (c, torch.float32)
        return {"m": {k: (s, torch.bfloat16) for k, s in shapes.items()},
                "vr": vr, "vc": vc}

    return Optimizer("adafactor_m", init, update, state_shapes)


def get_optimizer(name: str, cfg: OptConfig = OptConfig()) -> Optimizer:
    if name == "adamw":
        return adamw(cfg)
    if name == "adafactor_m":
        return adafactor_m(cfg)
    raise KeyError(name)
