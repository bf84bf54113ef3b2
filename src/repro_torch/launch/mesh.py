"""Device meshes, rank layouts and process groups of the port.

PyTorch has no mesh object. Three stand-ins are used:

* the sweep launcher's mesh (``make_sweep_mesh``): a tuple of
  ``torch.device``, one entry a shard; a device may appear more than once
  (two shards on one card run one after the other);
* a rank layout (:class:`RankLayout`: axis names and sizes, no device
  touched), the reference's ``make_production_mesh`` / ``make_host_mesh``;
  ``rules_for`` derives its ``AxisRules`` as the reference does;
* a process group (``spawn_group``), the reference's ``shard_map``: n
  spawned ranks joined by ``torch.distributed``, on which the collective
  schedules of ``core/collectives.py`` run. Given a (data, model)
  ``layout`` each rank also gets its row (the ranks of its data index:
  the TP group) and its column (the ranks of its model index: the data-
  and expert-parallel group); rank r sits at (r // model, r % model), as
  the reference's mesh orders its devices.

The transport of a process group is the caller's explicit choice:
``"nccl"`` puts rank r on ``cuda:r`` and needs one card per rank;
``"gloo"`` runs the ranks on the CPU or on one named card (where a CUDA
tensor's point-to-point sends go through the host,
``collectives.stage``). Nothing here picks a transport by what the
machine has.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Tuple

import torch

from repro_torch.models.layers import AxisRules

BACKENDS = ("gloo", "nccl")


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """A mesh without devices: axis names and sizes, the first axis
    major."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int) -> dict:
        """{axis: index} of ``rank``."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.shape)):
            out[name] = rank % n
            rank //= n
        return {a: out[a] for a in self.axis_names}


def make_production_mesh(*, multi_pod: bool = False) -> RankLayout:
    """The reference's production layouts: (data 16, model 16), or (pod
    2, data 16, model 16)."""
    if multi_pod:
        return RankLayout(("pod", "data", "model"), (2, 16, 16))
    return RankLayout(("data", "model"), (16, 16))


def make_host_mesh(data: int = 0, model: int = 1) -> RankLayout:
    """A (data, model) layout over the ranks of the live default group, or
    one rank without one."""
    import torch.distributed as dist
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    data = data or max(1, n // model)
    return RankLayout(("data", "model"), (data, model))


def rules_for(cfg, layout: RankLayout) -> AxisRules:
    """AxisRules of an arch config and a layout, as the reference's
    ``rules_for`` (``repro/launch/mesh.py:53``)."""
    names = tuple(layout.axis_names)
    has_pod = "pod" in names
    dp = ("pod", "data") if has_pod else ("data",)
    if cfg is not None and cfg.pod_param_sharding == "fsdp" and has_pod:
        fsdp = ("pod", "data")
    else:
        fsdp = ("data",)
    return AxisRules(dp=dp, fsdp=fsdp, tp="model", ep=fsdp,
                     kv_seq="model", sizes=layout.sizes)


def make_sweep_mesh(n_devices: int = 0, *, device=None
                    ) -> Tuple[torch.device, ...]:
    """The flat mesh that launch/sweep.py splits an engine batch over.

    Without ``device``: the CUDA devices, or the first ``n_devices`` of
    them; without a card that is an error. With ``device``: that device
    ``n_devices`` times (at least once), e.g. two shards on the CPU or two
    on ``cuda:0``."""
    if device is not None:
        return (torch.device(device),) * max(1, int(n_devices))
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_sweep_mesh takes the CUDA devices by default and none is "
            "available; pass device='cpu' for a mesh on the CPU")
    devs = tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))
    return devs[:int(n_devices)] if n_devices else devs


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a spawned rank's function is given: its rank, the group's
    size and its device; under a (data, model) layout also its place
    (``coords``) and its ``row`` (TP) and ``col`` (data and expert
    parallel) subgroups."""

    rank: int
    size: int
    device: torch.device
    coords: dict = None
    row: object = None
    col: object = None


def layout_groups(layout, rank: int):
    """({"data": i, "model": j}, row, col) of ``rank`` = i * model + j in
    a (data, model) layout of the live default group. Every rank must call
    it with the same layout: it creates every row and column subgroup
    (``dist.new_group``), rows first, in the same order on every rank."""
    import torch.distributed as dist
    data, model = layout
    rows = [dist.new_group([i * model + j for j in range(model)])
            for i in range(data)]
    cols = [dist.new_group([i * model + j for i in range(data)])
            for j in range(model)]
    return ({"data": rank // model, "model": rank % model},
            rows[rank // model], cols[rank % model])


def rank_devices(n: int, backend: str, device="cuda"):
    """The device of each of ``n`` ranks. ``"cpu"``: the CPU (gloo only).
    ``"cuda"``: under nccl rank r on ``cuda:r``, which needs n cards;
    under gloo every rank on ``cuda:0``. ``"cuda:k"``: every rank on that
    card (gloo only)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no process group on {dev}")
    if backend == "nccl":
        if dev.type != "cuda" or dev.index is not None:
            raise ValueError("nccl puts rank r on cuda:r: pass "
                             "device='cuda'")
        cards = torch.cuda.device_count()
        if n > cards:
            raise RuntimeError(f"nccl needs one card per rank: {n} ranks, "
                               f"{cards} card(s)")
        return [torch.device("cuda", r) for r in range(n)]
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' for ranks "
                               "on the CPU")
        dev = torch.device("cuda", dev.index or 0)
    return [dev] * n


def _rank_main(fn, rank, n, backend, device, rendezvous, out, timeout_s,
               args, layout=None):
    """A spawned rank: one ATen thread (the ranks share the cores), its
    device set, the group joined through the rendezvous file, ``fn(Rank,
    *args)`` run, the group torn down; the result or the traceback
    pickled to ``out``."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import torch.distributed as dist
    try:
        dist.init_process_group(
            backend, init_method=f"file://{rendezvous}", world_size=n,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            ctx = Rank(rank, n, dev)
            if layout is not None:
                ctx = Rank(rank, n, dev, *layout_groups(layout, rank))
            res = {"ok": True, "result": fn(ctx, *args)}
        except Exception:
            # written before the group goes down, so that the peers' own
            # failures (a closed connection) come after this one
            _dump(out, {"ok": False, "error": traceback.format_exc()})
            raise
        finally:
            dist.destroy_process_group()
    except Exception:
        if not os.path.exists(out):
            _dump(out, {"ok": False, "error": traceback.format_exc()})
        return
    _dump(out, res)


def _dump(path, res):
    with open(path + ".tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(path + ".tmp", path)


def spawn_group(fn: Callable, n: int, *, backend: str, device="cuda",
                args: tuple = (), timeout_s: float = 600.0,
                layout: Tuple[int, int] = None) -> list:
    """Run ``fn(Rank, *args)`` on each of ``n`` spawned ranks of one
    ``torch.distributed`` group over ``backend`` and return the ranks'
    results in rank order. ``fn`` must be a module-level function (it is
    pickled by name) and its result picklable without a card (tensors on
    the CPU). The rendezvous is a file in a fresh temporary directory, so
    no port is fixed. A rank that fails stops the others and raises here
    with its traceback; so does a rank still running ``timeout_s`` after
    the spawn. With ``layout`` (data, model), data * model == n, each
    rank also gets its coordinates and row and column subgroups
    (:class:`Rank`)."""
    if layout is not None and math.prod(layout) != n:
        raise ValueError(f"layout {layout} does not hold {n} ranks")
    devices = rank_devices(n, backend, device)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_group_") as tmp:
        rdv = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, n, backend, str(devices[r]), rdv, outs[r], timeout_s,
            args, layout and tuple(layout))) for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if not p.is_alive() and p.exitcode != 0), None)
                if failed is None:
                    failed = next((r for r, o in enumerate(outs)
                                   if os.path.exists(o)
                                   and not _load(o)["ok"]), None)
                if failed is not None or time.time() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors = [], []  # errors: (written at, rank, text)
        for r, o in enumerate(outs):
            if not os.path.exists(o):
                errors.append((math.inf, r, f"no result (exit code "
                                            f"{procs[r].exitcode})"))
                continue
            res = _load(o)
            if res["ok"]:
                results.append(res["result"])
            else:
                errors.append((os.path.getmtime(o), r, res["error"]))
    if errors:
        first = min(errors)  # the rank that failed first, in full
        lines = "; ".join(f"rank {r}: {t.strip().splitlines()[-1]}"
                          for _, r, t in sorted(errors, key=lambda e: e[1]))
        raise RuntimeError(
            f"spawn_group({getattr(fn, '__name__', fn)}, {n}, {backend}): "
            f"{len(errors)} rank(s) failed ({lines}); first, rank "
            f"{first[1]}:\n{first[2]}")
    return results


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)
