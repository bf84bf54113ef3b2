"""Training loop of the port, as ``repro/runtime/train_loop.py``:
microbatching, async checkpoint/restart, straggler monitoring and failure
recovery, on one device (no mesh, so no elastic rescale).

The loop is host-driven, Python around an eager train step, with every
policy injectable so the tests run it end to end on the CPU in seconds.
The trainer runs on the CUDA device unless it is given ``device="cpu"``;
without a card the default raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import (init_train_state, make_train_step,
                                      train_state_shapes)
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import OptConfig, get_optimizer
from repro_torch.runtime import fault


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    microbatches: int = 1  # gradient-accumulation factor
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3
    log_every: int = 10
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    seed: int = 0
    straggler_threshold: float = 4.0
    max_restarts: int = 4


def make_microbatched_train_step(model, optimizer, n_micro: int):
    """Gradient accumulation: the batch's leading dim is split into
    ``n_micro`` consecutive microbatches, each one's gradients accumulate
    in float32, then one update on their mean. Peak activation memory
    drops about ``n_micro``-fold while the optimizer still sees the
    full-batch gradient."""
    if n_micro == 1:
        return make_train_step(model, optimizer)

    def train_step(state, batch):
        B = len(batch["tokens"])
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             "microbatches")
        b = B // n_micro
        params = state["params"]
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in params.items()}
        loss_sum, losses, auxes = 0.0, [], []
        for i in range(n_micro):
            mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            for p in params.values():
                p.grad = None
            loss, metrics = model.loss(mb)
            loss.backward()
            for k, p in params.items():
                if p.grad is not None:
                    acc[k] += p.grad.float()
            loss_sum = loss_sum + loss.detach()
            losses.append(metrics["loss"].detach())
            auxes.append(metrics["aux_loss"].detach())
        grads = {k: g / n_micro for k, g in acc.items()}
        _, opt, gnorm = optimizer.update(grads, state["opt"], params,
                                         state["step"])
        out_metrics = {"loss": torch.stack(losses).mean(),
                       "aux_loss": torch.stack(auxes).mean(),
                       "total_loss": loss_sum / n_micro,
                       "grad_norm": gnorm}
        return {"params": params, "opt": opt,
                "step": state["step"] + 1}, out_metrics

    return train_step


class Trainer:
    """Drives one model on one device; survives injected failures by
    restoring the latest checkpoint."""

    def __init__(self, arch_cfg, tc: TrainConfig, dataset=None,
                 failure_injector=None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the trainer runs on the card "
                               "unless it is given device='cpu'")
        self.arch_cfg = arch_cfg
        self.tc = tc
        self.failure_injector = failure_injector or fault.FailureInjector()
        self.monitor = fault.StepMonitor(threshold=tc.straggler_threshold)
        self.dataset = dataset
        self.metrics_log: List[Dict] = []
        self.restarts = 0
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        cfg, tc = self.arch_cfg, self.tc
        self.model = build_model(cfg, device=self.device)
        self.optimizer = get_optimizer(cfg.optimizer, tc.opt)
        self.step_fn = make_microbatched_train_step(
            self.model, self.optimizer, tc.microbatches)
        if self.dataset is None:
            self.dataset = SyntheticLM(DataConfig(
                vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                seed=tc.seed))
        self.ckpt = (ckpt.AsyncCheckpointer(tc.ckpt_dir, keep=tc.ckpt_keep)
                     if tc.ckpt_dir else None)

    def _like(self) -> dict:
        """The reference-layout tree of the train state's shapes (meta
        tensors), for ``checkpoint.restore``."""
        shapes = train_state_shapes(self.model, self.optimizer)

        def meta(flat):
            return {k: torch.empty(shape, dtype=dtype, device="meta")
                    for k, (shape, dtype) in flat.items()}

        return convert.train_state_to_jax({
            "params": meta(shapes["params"]),
            "opt": {k: meta(v) for k, v in shapes["opt"].items()},
            "step": 0})

    def _init_or_restore(self):
        tc = self.tc
        if tc.ckpt_dir and ckpt.latest_step(tc.ckpt_dir) is not None:
            tree = ckpt.restore(tc.ckpt_dir, self._like())
            got = convert.train_state_from_jax(tree, self.device)
            self.model.load_params(got["params"])
            self.model.requires_grad_(True)
            params = dict(self.model.named_parameters())
            state = {"params": params, "opt": got["opt"],
                     "step": got["step"]}
        else:
            gen = torch.Generator(device=self.device).manual_seed(tc.seed)
            state = init_train_state(self.model, self.optimizer, gen)
        return state, state["step"]

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        tc = self.tc
        policy = fault.RestartPolicy(max_restarts=tc.max_restarts)
        while True:
            try:
                return self._run_once()
            except fault.NodeFailure:
                self.restarts += 1
                if not policy.should_restart():
                    raise
                # recovery: wait for the in-flight checkpoint, resume
                if self.ckpt:
                    self.ckpt.wait()

    def _run_once(self) -> Dict:
        tc = self.tc
        state, start = self._init_or_restore()
        for step in range(start, tc.total_steps):
            self.failure_injector.check(step)
            self.monitor.start_step()
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["total_loss"])  # sync point
            st = self.monitor.end_step(step)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at {step}")
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "step_s": st.duration_s,
                   "straggler": st.flagged}
            self.metrics_log.append(rec)
            next_step = step + 1
            if self.ckpt and (next_step % tc.ckpt_every == 0
                              or next_step == tc.total_steps):
                self.ckpt.save(next_step, convert.train_state_to_jax(
                    dict(state, step=next_step)), extra_meta={"loss": loss})
        if self.ckpt:
            self.ckpt.wait()
        losses = [m["loss"] for m in self.metrics_log]
        return {"final_loss": losses[-1] if losses else float("nan"),
                "first_loss": losses[0] if losses else float("nan"),
                "steps_run": len(self.metrics_log),
                "restarts": self.restarts,
                "stragglers": sum(m["straggler"] for m in self.metrics_log),
                "log": self.metrics_log}
