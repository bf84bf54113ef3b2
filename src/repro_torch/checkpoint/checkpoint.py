"""Checkpointing of the port, in the JAX package's layout, so that either
package can resume the other's float32 runs.

Layout (one directory per step), as ``repro/checkpoint/checkpoint.py``::

    <root>/step_00000420/
        index.json        # leaf keys, shapes, dtypes, meta
        leaf_00000.npy    # one array per leaf, in sorted key order
        COMMIT            # written last; a directory without it is ignored

A state is a nested dict whose leaves are tensors, numpy arrays or ints;
a leaf's key is its path joined by ``/`` (``params/embed/tok``,
``opt/m/layers/attn/wq``, ``step``), as the reference's tree paths.
Writers target ``step_X.tmp`` and rename it into place after the COMMIT
marker, so a crashed writer never leaves a half checkpoint that
``latest_step`` would take. bfloat16 leaves are stored as their raw 16
bits (uint16), which plain numpy reads, with ``bfloat16`` in the index;
a bfloat16 array the reference wrote (numpy void of 2 bytes) is read the
same way. ``AsyncCheckpointer`` copies the state to host memory on the
caller's thread before ``save`` returns, since the trainer updates its
parameters in place, and writes the files on a worker thread.

One device: ``specs`` and ``mesh`` are accepted and ignored, as in the
reference's single-host case, and every leaf is recorded as shard 0 of 1.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf, always a copy, so later
    in-place updates of the leaf cannot reach it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if arr.dtype.kind == "V":  # the reference's ml_dtypes bfloat16
            arr = arr.view(np.uint16)
        return torch.from_numpy(arr.astype(np.uint16).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=dtype))


def _write(root: str, step: int, host: dict, extra_meta: Optional[dict]):
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    index = {"step": int(step), "n_shards": 1, "shard": 0,
             "meta": extra_meta or {}, "leaves": {}}
    for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        index["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                "dtype": dtype}
    with open(os.path.join(tmp, "index.json"), "w") as f:
        json.dump(index, f)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save(root: str, step: int, state: Any, specs: Optional[Any] = None,
         extra_meta: Optional[dict] = None) -> str:
    """Synchronous checkpoint write with atomic commit. Returns the path."""
    host = {k: _to_host(v) for k, v in _flatten(state).items()}
    return _write(root, step, host, extra_meta)


def latest_step(root: str) -> Optional[int]:
    """Highest committed step under ``root`` (ignores partial writes)."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "COMMIT")):
            best = max(best or 0, int(m.group(1)))
    return best


def restore(root: str, like: Any, *, step: Optional[int] = None,
            mesh=None, specs: Optional[Any] = None) -> Any:
    """Load a checkpoint into the structure of ``like`` (a nested dict
    whose leaves are tensors, meta tensors included, or arrays), as CPU
    tensors in the stored dtypes. Raises on a missing leaf or a shape
    that differs from ``like``'s."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)

    def load(node, prefix):
        out = {}
        for k, ref in node.items():
            key = f"{prefix}{k}"
            if isinstance(ref, dict):
                out[k] = load(ref, key + "/")
                continue
            if key not in index["leaves"]:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            entry = index["leaves"][key]
            arr = np.load(os.path.join(d, entry["file"]))
            want = tuple(ref.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"leaf {key!r}: checkpoint shape "
                                 f"{arr.shape} != {want}")
            out[k] = _from_host(arr, entry["dtype"])
        return out

    return load(like, "")


def checkpoint_step_meta(root: str, step: int) -> dict:
    with open(os.path.join(root, f"step_{step:08d}", "index.json")) as f:
        return json.load(f)["meta"]


def cleanup(root: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(root):
        return
    steps = sorted(s for s in (
        int(m.group(1)) for m in (_STEP_RE.match(n) for n in os.listdir(root))
        if m) if os.path.exists(os.path.join(root, f"step_{s:08d}", "COMMIT")))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Snapshot to host memory on the caller's thread, file I/O on a worker
    thread; ``wait()`` joins the writer (before the next save, at exit and
    before a restore)."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, step: int, state: Any, specs=None, extra_meta=None):
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(state).items()}

        def _run():
            try:
                self.last_path = _write(self.root, step, host, extra_meta)
                cleanup(self.root, self.keep)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
