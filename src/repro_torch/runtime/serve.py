"""Batched serving runtime of the port: wave scheduling, right-padding,
greedy / temperature sampling.

Mirrors ``repro/runtime/serve.py``. The model decodes a whole batch at one
shared position, so requests run in *waves*: a wave admits up to
``max_batch`` queued requests, right-pads their prompts to the wave's
longest, prefills once (kernels 6 and 7 run there, once per layer), then
decodes until every member finishes (EOS or its token budget).
Temperature sampling draws from a seeded ``torch.Generator`` on the
model's device; it cannot reproduce ``jax.random``, so only greedy
decoding matches the reference token for token.

A VLM's wave gets zero ``patches`` and an encoder-decoder's zero
``frames`` (B, n_frontend_tokens, d_model), as the reference's server
gives them. A VLM's prefill cache holds the patches' positions too, so its
decode positions count them and its KV cache is padded from its real
length. There the port departs from the reference, whose server pads only
a cache of the prompt's length and so leaves a VLM's unpadded.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    submitted_s: float = 0.0
    # filled at completion
    tokens: Optional[np.ndarray] = None
    finish_reason: str = ""
    latency_s: float = 0.0


@dataclasses.dataclass
class ServerStats:
    requests_done: int = 0
    tokens_generated: int = 0
    waves: int = 0
    decode_steps: int = 0
    wall_s: float = 0.0
    # per wave: seconds from the wave's start to its first tokens on the
    # host (prefill and the first sample), then the seconds of its decode
    # calls and their number
    prefill_s: List[float] = dataclasses.field(default_factory=list)
    decode_s: List[float] = dataclasses.field(default_factory=list)
    decode_calls: List[int] = dataclasses.field(default_factory=list)
    # decode or prefill outputs whose logits held a NaN or an infinity
    nonfinite_logits: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / self.wall_s if self.wall_s else 0.0


class BatchedServer:
    def __init__(self, model, *, max_batch: int = 8, max_seq: int = 512,
                 eos_id: int = -1, pad_id: int = 0, seed: int = 0):
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.queue: Deque[Request] = deque()
        self.done: List[Request] = []
        self.stats = ServerStats()
        self._uid = 0
        self._gen = torch.Generator(device=model.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               temperature: float = 0.0) -> int:
        self._uid += 1
        self.queue.append(Request(
            uid=self._uid, prompt=np.asarray(prompt, np.int32),
            max_new_tokens=max_new_tokens, temperature=temperature,
            submitted_s=time.monotonic()))
        return self._uid

    # ------------------------------------------------------------------
    def n_front(self) -> int:
        """Positions a VLM's patches take before the prompt (0 otherwise)."""
        cfg = self.model.cfg
        return cfg.n_frontend_tokens if cfg.family == "vlm" else 0

    def _pad_cache(self, cache: dict, extra: int):
        """Grow a full-attention KV cache (``k``, ``v``: (L, B, S, KH, D),
        S counting a VLM's patches) by ``extra`` positions so decode can
        write its tokens; an encoder-decoder's cross caches (``xk``,
        ``xv``) and a sliding window's ring stay as they are."""
        if extra <= 0 or self.model.cfg.sliding_window:
            return cache
        for key in ("k", "v"):
            x = cache.get(key)
            if x is not None and x.dim() == 5:
                cache[key] = torch.nn.functional.pad(
                    x, (0, 0, 0, 0, 0, extra))
        return cache

    def _sample(self, logits, temperature: float):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def make_batch_inputs(self, wave: List[Request], S: int) -> dict:
        """The wave's prompts right-padded to S with ``pad_id``; a VLM's
        zero ``patches`` or an encoder-decoder's zero ``frames``."""
        toks = np.full((len(wave), S), self.pad_id, np.int32)
        for i, r in enumerate(wave):
            toks[i, : len(r.prompt)] = r.prompt[:S]
        dev = self.model.device
        batch = {"tokens": torch.as_tensor(toks, dtype=torch.int64,
                                           device=dev)}
        cfg = self.model.cfg
        front = {"vlm": "patches", "audio": "frames"}.get(cfg.family)
        if front:
            batch[front] = torch.zeros(
                (len(wave), cfg.n_frontend_tokens, cfg.d_model),
                dtype=torch.float32, device=dev)
        return batch

    # ------------------------------------------------------------------
    def step_wave(self) -> int:
        """Admit up to max_batch requests, run one full wave. Returns the
        number of requests completed."""
        if not self.queue:
            return 0
        t0 = time.monotonic()
        wave: List[Request] = []
        while self.queue and len(wave) < self.max_batch:
            wave.append(self.queue.popleft())
        B = len(wave)
        S = max(len(r.prompt) for r in wave)
        budget = min(max(r.max_new_tokens for r in wave), self.max_seq - S)
        batch = self.make_batch_inputs(wave, S)

        logits, cache = self.model.prefill(batch)
        # counted on the device, read once at the end of the wave
        nonfinite = (~torch.isfinite(logits)).any().long()
        cache = self._pad_cache(cache, budget)
        n_front = self.n_front()

        out_tokens = np.full((B, budget), self.pad_id, np.int32)
        alive = np.ones((B,), bool)
        temperature = max(r.temperature for r in wave)
        next_tok = self._sample(logits, temperature)
        t_first = None
        calls = 0
        for t in range(budget):
            tok_np = next_tok.cpu().numpy().astype(np.int32)
            if t_first is None:
                t_first = time.monotonic()
            for i, r in enumerate(wave):
                if alive[i]:
                    out_tokens[i, t] = tok_np[i]
                    if tok_np[i] == self.eos_id \
                            or t + 1 >= r.max_new_tokens:
                        alive[i] = False
                        r.finish_reason = ("eos" if tok_np[i] == self.eos_id
                                           else "length")
            self.stats.decode_steps += 1
            if not alive.any():
                break
            logits, cache = self.model.decode(cache, next_tok[:, None],
                                              S + n_front + t)
            calls += 1
            nonfinite += (~torch.isfinite(logits)).any()
            next_tok = self._sample(logits, temperature)

        self.stats.nonfinite_logits += int(nonfinite)
        end = time.monotonic()
        t_first = end if t_first is None else t_first
        self.stats.prefill_s.append(t_first - t0)
        self.stats.decode_s.append(end - t_first)
        self.stats.decode_calls.append(calls)
        for i, r in enumerate(wave):
            n_gen = int((out_tokens[i] != self.pad_id).sum())
            r.tokens = out_tokens[i][: max(n_gen, 1)]
            r.latency_s = time.monotonic() - r.submitted_s
            if not r.finish_reason:
                r.finish_reason = "length"
            self.done.append(r)
            self.stats.requests_done += 1
            self.stats.tokens_generated += len(r.tokens)
        self.stats.waves += 1
        self.stats.wall_s += end - t0
        return B

    def run_until_drained(self, max_waves: int = 100) -> ServerStats:
        for _ in range(max_waves):
            if not self.queue:
                break
            self.step_wave()
        return self.stats
