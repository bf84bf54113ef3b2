"""Counts of one step of the port, in the layout of the reference's
``launch/hlo_stats.py::analyze``.

The reference parses the optimized HLO text of XLA's per-device program,
which PyTorch does not have. Its twin here counts one step as it runs,
on meta tensors in the dry run (``launch/dryrun.py``):

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops
  (the matrix products, as the reference counts dots and convolutions),
  plus the hand-written kernels' calls recorded by their meta branches
  (``kernels.ops.record_meta``). Kernel 7 counts as the reference's XLA
  attention counts it (``repro/models/layers.py:225-296``): every KV
  chunk, masked or not, 4 * B * Sq * Skv_pad * H * D forward, Skv padded
  to the config's ``attn_chunk``; its backward 10 units (the QK product
  it recomputes, then dP, dV, dQ, dK), the reference's checkpointed chunk
  body the same five. The selective scan counts the reference's one dot
  (``einsum("bcdn,bcn->bcd")``, 2 * B * T * Di * N) and two in its
  backward;
* bytes: each aten op's operand and result bytes, taken by a
  ``TorchDispatchMode``. Views, allocations and metadata ops move none; a
  gather or index reads what it writes (2x its result, as the reference
  counts a slice); an in-place index write moves its update (the
  reference's dynamic-update-slice rule); a copy reads and writes its
  source's bytes. Kernel calls and collectives add their operands and
  results;
* collectives: the records of ``core.collectives.StandInGroup`` with the
  ring model's per-rank wire bytes (:func:`wire_bytes`, the reference's
  verbatim);
* memory: the live tensor bytes over the step, each storage added when an
  op makes it and taken off by a finalizer when it dies; the arguments
  (parameters, optimizer state, batch, cache) are live throughout.

Rows are named by the innermost function of ``repro_torch`` that issued
the op and the op (``models.moe._experts/bmm``).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import collectives
from repro_torch.kernels import ops

# ops that move no bytes (allocation, metadata)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "set_", "resize_", "_unsafe_view"}
# ops that read only what they write
_GATHERS = {"index", "index_select", "gather", "embedding"}
# in-place index writes: the update's bytes
_UPDATES = {"index_put", "index_put_", "index_copy", "index_copy_",
            "scatter", "scatter_", "scatter_add", "scatter_add_",
            "index_add", "index_add_", "slice_scatter", "select_scatter"}


def wire_bytes(kind: str, operand: float, result: float, g: int) -> float:
    """Per-chip bytes moved over links, ring-algorithm model."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2 * frac * result
    if kind == "all-gather":
        return frac * result
    if kind == "reduce-scatter":
        return frac * operand
    if kind in ("all-to-all", "ragged-all-to-all"):
        return frac * operand
    if kind == "collective-permute":
        return float(result)
    return 0.0


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **__) -> int:
    """A batched product's FLOPs, also for the ``out_dtype`` overload that
    FlopCounterMode's own formula does not take."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


# FlopCounterMode's custom_mapping: the port's float32-out bmm
FLOP_MAPPING = {torch.ops.aten.bmm: _bmm_flop}


def attention_units(B, Sq, Skv, H, D, chunk: int) -> int:
    """B * Sq * Skv_pad * H * D, Skv padded to a multiple of
    min(chunk, Skv) as the reference's blockwise attention pads it."""
    c = max(1, min(chunk, Skv))
    return B * Sq * (-(-Skv // c) * c) * H * D


def kernel_flops(call: dict, attn_chunk: int) -> int:
    """FLOPs of one recorded kernel call, counted as the reference's XLA
    program counts the same work (module docstring)."""
    k = call["kernel"]
    if k in ("flash_attention", "flash_attention_bwd"):
        B, Sq, Skv, H, _, D = call["dims"]
        units = attention_units(B, Sq, Skv, H, D, attn_chunk)
        return (4 if k == "flash_attention" else 10) * units
    B, T, Di, N = call["dims"]
    return (2 if k == "fused_selective_scan" else 4) * B * T * Di * N


def attention_recompute_flops(call: dict, attn_chunk: int) -> int:
    """The QK product a backward call recomputes (2 units; in both
    packages' counts), 0 for any other call."""
    if call["kernel"] != "flash_attention_bwd":
        return 0
    B, Sq, Skv, H, _, D = call["dims"]
    return 2 * attention_units(B, Sq, Skv, H, D, attn_chunk)


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _label() -> str:
    return collectives.caller(__file__) or "step"


class _OpMode(TorchDispatchMode):
    def __init__(self, counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._op(func, args, kwargs, out)
        return out


class StepCounter:
    """Counts what the ops inside its block do (module docstring). Enter
    it, register the step's arguments (:meth:`arguments`), run the step,
    then read :meth:`result`. ``attn_chunk`` is the config's; collectives
    come from ``records``, the list the cell's ``StandInGroup``s share."""

    def __init__(self, *, attn_chunk: int = 1024, records=None):
        self.attn_chunk = attn_chunk
        self.records = records if records is not None else []
        self.kernel_calls: list = []
        self.hbm = 0.0
        self.bytes_by_op = defaultdict(float)
        self.dots: list = []
        self.live: dict = {}
        self.cur = self.peak = 0
        self.argument_bytes = 0
        self._args: set = set()
        self._stack = []

    # ---- live bytes ----
    def _free(self, key):
        self.cur -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        if key in self.live:
            return 0
        n = st.nbytes()
        self.live[key] = n
        self.cur += n
        weakref.finalize(st, self._free, key)
        return n

    def arguments(self, *trees) -> int:
        """Count the tensors of ``trees`` as live for the whole step."""
        for t in _tensors(trees):
            n = self._track(t)
            self.argument_bytes += n
            self._args.add(id(t.untyped_storage()))
        self.peak = max(self.peak, self.cur)
        return self.argument_bytes

    # ---- per op ----
    def _op(self, func, args, kwargs, out):
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        self.peak = max(self.peak, self.cur)
        name = func.overloadpacket.__name__
        if func.is_view or name in _NO_BYTES:
            return
        ins = _tensors((args, kwargs))
        rb = sum(_nbytes(t) for t in outs)
        if name in _GATHERS:
            nb = 2 * rb
        elif name in _UPDATES:
            ob = sum(_nbytes(t) for t in ins)
            nb = max(ob + rb - 2 * max((_nbytes(t) for t in ins),
                                       default=0), 0)
        elif name in ("copy", "copy_"):
            nb = _nbytes(ins[1]) + _nbytes(ins[0]) if len(ins) > 1 else rb
        else:
            nb = sum(_nbytes(t) for t in ins) + rb
        label = f"{_label()}/{name}"
        self.hbm += nb
        self.bytes_by_op[label] += nb
        fn = self._fc.flop_registry.get(func.overloadpacket)
        if fn is not None:
            f = fn(*args, **kwargs, out_val=out)
            if f:
                self.dots.append((float(f), label))

    def __enter__(self):
        self._fc = FlopCounterMode(display=False, custom_mapping=FLOP_MAPPING)
        self._stack = [self._fc, ops.record_meta(self.kernel_calls),
                       _OpMode(self)]
        for c in self._stack:
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in reversed(self._stack):
            c.__exit__(*exc)
        return False

    # ---- the analysis dict ----
    def result(self, outputs=None) -> dict:
        """The reference's ``analyze`` dict (``flops``, ``hbm_bytes``,
        ``collectives``, ``top_dots``, ``top_collectives``,
        ``top_bytes``), with the aten and kernel FLOPs apart, the
        backward's attention recompute term, the kernel calls, and
        ``memory``: the arguments, the outputs (those that are arguments
        updated in place as ``alias_bytes``), the step's own live bytes
        at their peak past the arguments and new outputs (``temp_bytes``)
        and ``peak_per_device_bytes``, the peak of all live bytes."""
        aten = float(self._fc.get_total_flops())
        dots = list(self.dots)
        kflops = recompute = 0.0
        hbm = self.hbm
        by_op = defaultdict(float, self.bytes_by_op)
        n_calls = defaultdict(int)
        for call in self.kernel_calls:
            f = kernel_flops(call, self.attn_chunk)
            kflops += f
            recompute += attention_recompute_flops(call, self.attn_chunk)
            label = f"kernels.ops.{call['kernel']}"
            dots.append((float(f), label))
            hbm += call["bytes"]
            by_op[label] += call["bytes"]
            n_calls[call["kernel"]] += 1
        coll = defaultdict(lambda: {"count": 0.0, "operand_bytes": 0.0,
                                    "result_bytes": 0.0, "wire_bytes": 0.0})
        top_colls = []
        for r in self.records:
            w = wire_bytes(r["kind"], r["operand_bytes"], r["result_bytes"],
                           r["group_size"])
            d = coll[r["kind"]]
            d["count"] += 1
            d["operand_bytes"] += r["operand_bytes"]
            d["result_bytes"] += r["result_bytes"]
            d["wire_bytes"] += w
            nb = r["operand_bytes"] + r["result_bytes"]
            hbm += nb
            by_op[f"collective/{r['kind']}"] += nb
            top_colls.append((w, r["kind"], r["group_size"],
                              r.get("site", "")))
        total = {k: sum(d[k] for d in coll.values())
                 for k in ("count", "operand_bytes", "result_bytes",
                           "wire_bytes")}
        # summed by label, as the reference's rows sum a loop's visits
        dot_rows = defaultdict(float)
        for f, label in dots:
            dot_rows[label] += f
        top_dots = sorted(((f, n) for n, f in dot_rows.items()),
                          reverse=True)
        top_colls.sort(reverse=True)
        top_bytes = sorted(by_op.items(), key=lambda kv: -kv[1])
        outs = {}
        for t in _tensors(outputs):
            outs.setdefault(id(t.untyped_storage()),
                            (t.untyped_storage().nbytes(),
                             id(t.untyped_storage()) in self._args))
        out_bytes = sum(n for n, _ in outs.values())
        alias = sum(n for n, a in outs.values() if a)
        memory = {
            "argument_bytes": int(self.argument_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(max(self.peak - self.argument_bytes
                                  - (out_bytes - alias), 0)),
            "alias_bytes": int(alias),
            "peak_per_device_bytes": int(self.peak)}
        return {
            "flops": aten + kflops,
            "flops_aten": aten,
            "flops_kernels": kflops,
            "attention_recompute_flops": recompute,
            "hbm_bytes": hbm,
            "collectives": {"per_kind": {k: dict(v) for k, v in coll.items()},
                            "total": total},
            "top_dots": [(f, n) for f, n in top_dots[:12]],
            "top_collectives": [(w, k, g, n)
                                for w, k, g, n in top_colls[:12]],
            "top_bytes": [(b, n) for n, b in top_bytes[:16]],
            "kernel_calls": dict(n_calls),
            "memory": memory,
        }
