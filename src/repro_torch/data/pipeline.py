"""Deterministic synthetic LM data pipeline (a copy of
``repro/data/pipeline.py``: numpy only, so the batches are bit-equal to the
JAX package's).

Design goals (1000+-node deployments):

* **Stateless indexing** — batch ``i`` is a pure function of ``(seed, i)``,
  so checkpoint-restart needs to store only the step counter, and any host
  can regenerate any shard (no data-state gossip on restart).
* **Host sharding** — each host materializes only its slice of the global
  batch (``host_id/n_hosts``); the global batch is never assembled.
* **Learnable structure** — tokens follow an order-2 mixture pattern
  (token ~ f(prev, position band)) so a real model shows a monotonically
  decreasing loss, which the integration tests assert.

A file-backed reader (`TokenFileDataset`) with the same stateless-index
interface covers the "real corpus" path: a flat uint16/uint32 token file is
strided deterministically.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional

import numpy as np


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 — the per-element counter-based RNG."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    structure: float = 0.75  # fraction of tokens that follow the pattern


class SyntheticLM:
    """Infinite, deterministic, host-sharded token stream."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.n_hosts == 0, \
            (cfg.global_batch, cfg.n_hosts)
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        # a fixed random "grammar": successor table for the structured part
        rng = np.random.RandomState(cfg.seed ^ 0x5EED)
        self._succ = rng.randint(0, cfg.vocab_size,
                                 size=(cfg.vocab_size,), dtype=np.int64)

    # -- stateless batch indexing -------------------------------------------
    def batch_at(self, step: int) -> dict:
        """The (host-local) batch for global step ``step``."""
        c = self.cfg
        rows = (np.int64(step) * c.global_batch
                + c.host_id * self.local_batch
                + np.arange(self.local_batch, dtype=np.int64))
        # per-(row, col) counters -> uniform u64 lattice
        ctr = (rows[:, None].astype(np.uint64) << np.uint64(20)) \
            + np.arange(c.seq_len + 1, dtype=np.uint64)[None, :]
        u = _splitmix64(ctr ^ np.uint64(c.seed * 0x9E3779B1 + 1))
        rand_tok = (u % np.uint64(c.vocab_size)).astype(np.int64)
        keep_rand = (u >> np.uint64(32)) % np.uint64(1_000_000) \
            >= np.uint64(int(c.structure * 1_000_000))
        # order-1 structured successor chain, applied left-to-right
        toks = rand_tok.copy()
        for t in range(1, c.seq_len + 1):
            struct = self._succ[toks[:, t - 1]]
            toks[:, t] = np.where(keep_rand[:, t], rand_tok[:, t], struct)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class TokenFileDataset:
    """Flat binary token file with the same stateless-index interface.

    Layout: little-endian uint16 (vocab < 65536) or uint32 tokens. Batch
    ``i`` reads ``local_batch`` rows strided pseudo-randomly through the
    file (deterministic in ``(seed, i)``), wrapping at EOF.
    """

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._tok = np.memmap(path, dtype=dtype, mode="r")
        self._n = len(self._tok) - (cfg.seq_len + 1)
        assert self._n > 0, "token file shorter than one sample"

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rows = (np.int64(step) * c.global_batch
                + c.host_id * self.local_batch
                + np.arange(self.local_batch, dtype=np.int64))
        starts = (_splitmix64(rows.astype(np.uint64)
                              ^ np.uint64(c.seed + 77))
                  % np.uint64(self._n)).astype(np.int64)
        idx = starts[:, None] + np.arange(c.seq_len + 1)[None, :]
        toks = np.asarray(self._tok[idx], dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_token_file(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    tokens.astype(dtype).tofile(path)


def make_dataset(cfg: DataConfig, path: Optional[str] = None):
    if path and os.path.exists(path):
        return TokenFileDataset(path, cfg)
    return SyntheticLM(cfg)
