"""Train-step builders of the port, as ``repro/launch/steps.py``.

A train state is ``{"params", "opt", "step"}``: ``params`` is the model's
own parameters by name (the step updates them in place, so the model and
the state stay one), ``opt`` the optimizer's state, ``step`` an int. On
one device the specs are trivial; ``lower_cell`` is XLA tooling and waits
for the analogue of the dry run (ROADMAP Queue 1, item 15).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import init_params


def _grads(params: dict) -> dict:
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()}


def make_train_step(model, optimizer):
    """(state, batch) -> (state, metrics): the loss and its gradients
    (``model.loss``, then backward), then one optimizer update. Metrics as
    the reference's: ``loss``, ``aux_loss``, ``grad_norm`` and
    ``total_loss``, device scalars. The last gradients stay in the
    parameters' ``.grad``."""

    def train_step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        _, opt, gnorm = optimizer.update(_grads(params), state["opt"], params,
                                         state["step"])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(grad_norm=gnorm, total_loss=loss.detach())
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def param_shapes(model) -> dict:
    """{name: (shape, dtype)} of the model's parameters."""
    return {k: (tuple(p.shape), p.dtype)
            for k, p in model.named_parameters()}


def train_state_shapes(model, optimizer) -> dict:
    """{"params", "opt", "step"} of (shape, dtype) pairs, in the port's
    layout (``convert.train_state_to_jax`` stacks it)."""
    shapes = param_shapes(model)
    return {"params": shapes, "opt": optimizer.state_shapes(shapes),
            "step": ((), torch.int32)}


def train_state_specs(model, optimizer) -> dict:
    """Every leaf is whole on the one device: no specs."""
    return {"params": {k: None for k in param_shapes(model)},
            "opt": None, "step": None}


def init_train_state(model, optimizer, generator: torch.Generator) -> dict:
    """Parameters drawn from ``generator`` (``layers.init_params``) into the
    model, with gradients on, and the optimizer's zero state."""
    model.load_params(init_params(model.cfg, generator, model.param_dtype,
                                  model.device))
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"params": params, "opt": optimizer.init(params), "step": 0}
