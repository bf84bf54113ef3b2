"""Step builders shared by the dry run, the trainer and the server, as
``repro/launch/steps.py``.

A train state is ``{"params", "opt", "step"}``: ``params`` is the model's
own parameters by name (the step updates them in place, so the model and
the state stay one), ``opt`` the optimizer's state, ``step`` an int. On
one device the specs are trivial. ``lower_cell`` is the twin of the
reference's: where XLA lowers a cell to a program, it builds one rank's
step of a (arch x shape) cell on meta tensors, which the dry run
(``launch/dryrun.py``) counts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import collectives
from repro_torch.models.layers import RankGroups, init_params


def _grads(params: dict) -> dict:
    return {k: p.grad if p.grad is not None else torch.zeros_like(p)
            for k, p in params.items()}


def make_train_step(model, optimizer, grad_sync: Callable = None):
    """(state, batch) -> (state, metrics): the loss and its gradients
    (``model.loss``, then backward), then one optimizer update. Metrics as
    the reference's: ``loss``, ``aux_loss``, ``grad_norm`` and
    ``total_loss``, device scalars. The last gradients stay in the
    parameters' ``.grad``. ``grad_sync`` ({name: grad} -> {name: grad}),
    when given, runs between the backward and the update (a data-parallel
    mean)."""

    def train_step(state, batch):
        params = state["params"]
        for p in params.values():
            p.grad = None
        loss, metrics = model.loss(batch)
        loss.backward()
        grads = _grads(params)
        if grad_sync is not None:
            grads = grad_sync(grads)
        _, opt, gnorm = optimizer.update(grads, state["opt"], params,
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


# --------------------------------------------------------------------------
# Lowering (used by dryrun.py)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Lowered:
    """One rank's step of a cell on meta tensors. ``run()`` executes it
    once and returns its outputs; ``arguments`` are its inputs
    (parameters, optimizer state, batch or cache), live for the whole
    step; ``records`` collects the collectives of its stand-in groups."""

    kind: str
    model: object
    arguments: tuple
    run: Callable
    records: list


def _stand_in(size: int, records: list):
    return collectives.StandInGroup(size, records=records) if size > 1 \
        else None


def lower_cell(cfg, shape, layout, rules) -> Lowered:
    """One (arch x shape) cell of ``layout`` (``launch.mesh.RankLayout``)
    as one rank runs it: the model built on the meta device, its batch
    split over ``rules.dp`` (``api.batch_specs``), an MoE's expert leaves
    split as ``moe.moe_ffn`` splits them, every other layer whole on the
    rank. The ranks it talks to are ``StandInGroup``s of the layout's
    axis sizes, which record and move nothing. A training cell runs
    ``make_train_step`` with the gradients of whole leaves averaged over
    the data-parallel ranks (expert leaves over the data-parallel ranks
    that do not split them) and the config's optimizer. A ``seq_shard``
    config is refused: the port has no sequence parallelism, and splitting
    its tokens over the TP axis while each layer runs whole would count
    attention over S / tp keys."""
    from repro_torch.models import api
    from repro_torch.models import moe as moe_lib
    from repro_torch.optim.adamw import OptConfig, get_optimizer

    if cfg.seq_shard:
        raise NotImplementedError(
            f"{cfg.name}: seq_shard (sequence parallelism) is not ported; "
            "the port runs every dense layer whole on a rank")
    records: list = []
    groups = RankGroups(dp=_stand_in(rules.dp_size, records),
                        ep=_stand_in(rules.ep_size, records),
                        tp=_stand_in(rules.tp_size, records))
    if cfg.is_encdec:
        model = api.build_model(cfg, device="meta")
    else:
        model = api.build_model(cfg, device="meta", groups=groups,
                                rules=rules)

    def local(tensors: dict, specs: dict) -> dict:
        return {k: torch.empty(api.local_shape(v.shape, specs[k], rules),
                               dtype=v.dtype, device="meta")
                for k, v in tensors.items()}

    if shape.kind == "decode":
        (cache, tokens, pos), (cspecs, tspec, _) = api.decode_inputs(
            cfg, shape, model, rules)
        cache, tokens = local(cache, cspecs), local(
            {"t": tokens}, {"t": tspec})["t"]
        return Lowered("decode", model, (dict(model.named_parameters()),
                                         cache, tokens),
                       lambda: model.decode(cache, tokens, pos), records)
    batch = local(api.batch_shapes(cfg, shape),
                  api.batch_specs(cfg, rules, shape.global_batch))
    if shape.kind == "prefill":
        return Lowered("prefill", model, (dict(model.named_parameters()),
                                          batch),
                       lambda: model.prefill(batch), records)
    if shape.kind != "train":
        raise ValueError(shape.kind)
    model.requires_grad_(True)
    optimizer = get_optimizer(cfg.optimizer, OptConfig())
    params = dict(model.named_parameters())
    state = {"params": params, "opt": optimizer.init(params), "step": 0}
    whole_dp = groups.dp
    expert_rest = _stand_in(
        rules.dp_size // (rules.ep_size if moe_lib.expert_dims(cfg, rules)
                          != moe_lib.expert_dims(cfg) else 1), records) \
        if cfg.n_experts else None

    def grad_sync(grads):
        out = {}
        for k, g in grads.items():
            leaf = k.rsplit(".", 1)[-1]
            grp = expert_rest if (".ffn." in k and cfg.n_experts and leaf
                                  in moe_lib.EXPERT_LEAVES) else whole_dp
            out[k] = g if grp is None else collectives.all_mean(g, grp)
        return out

    step = make_train_step(model, optimizer,
                           grad_sync if rules.dp_size > 1 else None)
    return Lowered("train", model, (state["params"], state["opt"], batch),
                   lambda: step(state, batch), records)
