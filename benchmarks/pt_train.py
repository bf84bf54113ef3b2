"""Helpers of the port's training runs at full width: hymba-1.5b through
``repro_torch.runtime.train_loop.Trainer``.

``train`` builds the model at the config's full width in its own types,
draws its weights from a seeded ``torch.Generator``, and trains it on
``SyntheticLM`` batches with AdamW (float32 moments), the config's
activation checkpointing, a checkpoint every ``ckpt_every`` steps into a
temporary directory and injected node failures; ``chip_smoke.py``'s
``train`` phase drives it on the card. The command line for training is
``python -m repro_torch.launch.train``.

It also holds what the training reference rows share between the JAX
package (``benchmarks/pt_jax_reference.py --only train``) and the smoke
run: the reference configuration, its batches and its per-leaf summary.
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM

# the training reference rows: hymba at full width, 2 layers, float32;
# 3 AdamW steps on SyntheticLM batches of 2 x 1280 tokens (crossing the
# 1024 window). The step-0 warmup halves the learning rate; the gradient
# norm (about 2.9) is clipped to 1
TRAIN_REFERENCE = dict(
    arch="hymba-1.5b", n_layers=2, dtype="float32", batch=2, seq_len=1280,
    steps=3, param_seed=0, data_seed=0, probe_seed=2, n_probe=4,
    opt=dict(lr=1e-3, warmup_steps=2, decay_steps=3, b1=0.9, b2=0.95,
             eps=1e-8, weight_decay=0.1, grad_clip=1.0,
             moment_dtype="float32"))


# limits of a run against the training reference rows (reference_errors'
# keys): the loss and gradient norm per step (absolute), step 0's per-leaf
# gradient norms and probed gradients (relative to the leaf's norm), the
# probed parameters after the last step (absolute). The CPU plain path is
# 9.5e-7, 5e-6, 1.3e-7, 1.0e-7 and 1.2e-7 away; the adjoint shifted by one
# step moves the per-leaf norms 2.1e-3, a window one key too wide in the
# attention backward 6.7e-5
TRAIN_TOL = {"loss": 2e-5, "grad_norm": 5e-5, "grad0_norm_rel": 2e-5,
             "grad0_probe_rel": 2e-5, "params_after_abs": 1e-5}


def reference_config(ref=TRAIN_REFERENCE):
    """The ArchConfig of the training reference rows (port-side copy)."""
    return dataclasses.replace(get_config(ref["arch"]),
                               n_layers=ref["n_layers"],
                               param_dtype=ref["dtype"],
                               compute_dtype=ref["dtype"])


def reference_data(cfg, ref=TRAIN_REFERENCE) -> SyntheticLM:
    return SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=ref["seq_len"],
                                  global_batch=ref["batch"],
                                  seed=ref["data_seed"]))


def probe_index(state_dict_shapes: dict, ref=TRAIN_REFERENCE) -> dict:
    """{leaf name: sorted flat indices} of the probed elements, drawn per
    leaf in name order from ``probe_seed``."""
    rng = np.random.default_rng(ref["probe_seed"])
    out = {}
    for name in sorted(state_dict_shapes):
        n = int(np.prod(state_dict_shapes[name]))
        out[name] = sorted(int(i) for i in rng.choice(
            n, min(ref["n_probe"], n), replace=False))
    return out


def leaf_summary(tensors: dict, probes: dict) -> dict:
    """{leaf name: {"norm": float64 L2 norm, "probe": values at the probe
    indices}} of a state dict of tensors or numpy arrays."""
    out = {}
    for name, idx in probes.items():
        x = tensors[name]
        x = (x.detach().double().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x, np.float64)).reshape(-1)
        out[name] = {"norm": float(np.sqrt((x * x).sum())),
                     "probe": [float(x[i]) for i in idx]}
    return out


def reference_run(device, ref: dict, *, steps=None, core: str = "kernel"):
    """The training reference rows on the port: the reference's model,
    weights, batches and ``OptConfig`` (``ref``, the loaded
    ``jax_train_reference.json``) through ``make_train_step`` on
    ``device``, for ``steps`` steps (default all). Returns {"steps": [{loss,
    total_loss, grad_norm}], "grad0": step 0's leaf summary, "params_after":
    the leaf summary after the last step (None unless all steps ran)}."""
    from repro_torch import convert
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import numpy_params
    from repro_torch.optim.adamw import OptConfig, adamw
    r = ref["config"]
    cfg = reference_config(r)
    model = build_model(cfg, device=device, core=core).load_params(
        convert.lm_params_from_jax(numpy_params(cfg, r["param_seed"]), cfg))
    model.requires_grad_(True)
    opt = adamw(OptConfig(**r["opt"]))
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params), "step": 0}
    step_fn = make_train_step(model, opt)
    data = reference_data(cfg, r)
    probes = {k: list(v) for k, v in ref["probe_index"].items()}
    n = r["steps"] if steps is None else steps
    out = {"steps": [], "grad0": None, "params_after": None}
    for i in range(n):
        state, metrics = step_fn(state, data.batch_at(i))
        if i == 0:
            out["grad0"] = leaf_summary({k: p.grad for k, p in
                                         params.items()}, probes)
        out["steps"].append({k: float(metrics[k]) for k in
                             ("loss", "total_loss", "grad_norm")})
    if n == r["steps"]:
        out["params_after"] = leaf_summary(params, probes)
    return out


def reference_errors(got: dict, want: dict) -> dict:
    """The largest distances of a :func:`reference_run` from the reference
    rows: per-step loss and gradient norm (absolute), step 0's per-leaf
    gradient norms (relative to each norm) and probed gradients (relative
    to the leaf's gradient norm), and the probed parameters after the last
    step (absolute)."""
    out = {"loss": 0.0, "grad_norm": 0.0, "grad0_norm_rel": 0.0,
           "grad0_probe_rel": 0.0, "params_after_abs": None}
    for g, w in zip(got["steps"], want["steps"]):
        out["loss"] = max(out["loss"], abs(g["loss"] - w["loss"]))
        out["grad_norm"] = max(out["grad_norm"],
                               abs(g["grad_norm"] - w["grad_norm"]))
    for name, w in want["grad0"].items():
        g = got["grad0"][name]
        norm = max(w["norm"], 1e-30)
        out["grad0_norm_rel"] = max(out["grad0_norm_rel"],
                                    abs(g["norm"] - w["norm"]) / norm)
        out["grad0_probe_rel"] = max(out["grad0_probe_rel"], max(
            abs(a - b) for a, b in zip(g["probe"], w["probe"])) / norm)
    if got["params_after"] is not None:
        out["params_after_abs"] = max(
            max(abs(a - b) for a, b in zip(got["params_after"][k]["probe"],
                                           w["probe"]))
            for k, w in want["params_after"].items())
    return out


def train(cfg, device, *, steps: int = 8, batch: int = 4,
          seq_len: int = 1280, ckpt_every: int = 4, fail_at=(6,),
          seed: int = 0, ckpt_dir=None, instrument=None):
    """Train ``cfg`` on ``device`` from weights drawn with ``seed``:
    ``steps`` AdamW steps on SyntheticLM batches, a checkpoint every
    ``ckpt_every`` steps into ``ckpt_dir`` (a new temporary directory by
    default, removed after) and a node failure injected at each step of
    ``fail_at``. ``instrument(trainer)``, when given, runs before the
    training (the smoke run wraps the step to time it). Returns (trainer,
    result of ``Trainer.run``)."""
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.runtime import fault
    from repro_torch.runtime.train_loop import TrainConfig, Trainer
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                                  global_batch=batch, seed=seed))
    with tempfile.TemporaryDirectory() as tmp:
        tc = TrainConfig(total_steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt_dir or tmp, ckpt_keep=1, seed=seed,
                         opt=OptConfig(lr=3e-4, warmup_steps=2,
                                       decay_steps=steps))
        trainer = Trainer(cfg, tc, dataset=data, device=device,
                          failure_injector=fault.FailureInjector(fail_at))
        if instrument is not None:
            instrument(trainer)
        out = trainer.run()
    return trainer, out
