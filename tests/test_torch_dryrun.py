"""The port's dry run and roofline (``repro_torch.launch.{hlo_stats,
roofline,dryrun,mesh,steps}``, ``models.api``) against the JAX package's.

The reference's pure functions (``wire_bytes``, ``roofline``'s,
``rules_for``, ``batch_shapes``/``batch_specs``) run here on the same
inputs. Its dry run itself is not imported (``repro.launch.dryrun`` sets
512 host devices at import): its smoke cells come from
``artifacts/bench_cache_torch/jax_dryrun_reference.json``, which
``benchmarks/pt_jax_reference.py --only dryrun`` writes from child
processes. The port's cells are counted here on meta tensors.
"""
import dataclasses
import json
import os
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import all_arch_names  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.core import collectives  # noqa: E402
from repro_torch.launch import dryrun, hlo_stats, mesh, roofline  # noqa
from repro_torch.launch.steps import lower_cell  # noqa: E402
from repro_torch.models import api  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF = os.path.join(ROOT, "artifacts", "bench_cache_torch",
                   "jax_dryrun_reference.json")
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute", "ragged-all-to-all", "send")
FLOP_REL = 0.01


def reference_doc():
    with open(REF) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def smoke_cells():
    """The port's smoke cells of the reference file, counted here."""
    out = {}
    for key in reference_doc()["cells"]:
        arch, shape = key.split("__")[:2]
        out[key] = dryrun.run_cell(arch, shape, "single", smoke=True)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_matches_reference(kind):
    from repro.launch import hlo_stats as ref
    for g in (1, 2, 8, 256):
        for operand, result in ((1024.0, 256.0), (256.0, 1024.0),
                                (3.0e9, 3.0e9)):
            assert hlo_stats.wire_bytes(kind, operand, result, g) == \
                ref.wire_bytes(kind, operand, result, g)


def _cells():
    """The reference's committed smoke cells that ran, and copies relabeled
    so that ``pick_hillclimb_cells`` has its kimi-k2 train row and rows
    of every kind."""
    cells = [c for c in reference_doc()["cells"].values()
             if c["status"] == "ok"]
    extra = []
    for c, arch, shape in ((cells[0], "kimi-k2-1t-a32b", "train_4k"),
                           (cells[0], "grok-1-314b", "train_4k"),
                           (cells[1], "grok-1-314b", "prefill_32k"),
                           (cells[2], "hymba-1.5b", "decode_32k")):
        c = json.loads(json.dumps(c))
        c.update(arch=arch, shape=shape)
        c["roofline"]["collective_s"] = 1e-3 * (len(extra) + 1)
        c["hlo"]["collectives"]["per_kind"] = {
            "all-to-all": {"wire_bytes": 5.0}, "all-gather":
            {"wire_bytes": 7.0}}
        extra.append(c)
    return cells + extra


def test_roofline_functions_match_reference_with_v5e():
    """analyze_cell, _serving_useful_s, table and pick_hillclimb_cells with
    V5E on the reference's committed cells equal the reference's."""
    from repro.launch import roofline as ref
    cells = _cells()
    for c in cells:
        assert roofline.analyze_cell(c, roofline.V5E) == ref.analyze_cell(c)
        if "model_flops" not in c:
            assert roofline._serving_useful_s(c, roofline.V5E) == \
                ref._serving_useful_s(c)
    rows = [roofline.analyze_cell(c, roofline.V5E) for c in cells]
    assert roofline.table(rows) == ref.table(rows)
    assert roofline.pick_hillclimb_cells(rows) == \
        ref.pick_hillclimb_cells(rows)
    h = roofline.analyze_cell(cells[0])
    assert h == roofline.analyze_cell(cells[0], roofline.H100)
    assert h["compute_s"] == cells[0]["roofline"]["compute_s"]
    assert roofline.H100.name == "H100 80GB HBM3 (datasheet constants)"


@pytest.mark.parametrize("arch", all_arch_names())
def test_rules_for_matches_reference(arch):
    """Field by field on both production layouts and the host layout."""
    from repro.configs import get_config
    from repro.launch import mesh as ref
    for multi in (False, True):
        layout = mesh.make_production_mesh(multi_pod=multi)
        fake = types.SimpleNamespace(axis_names=layout.axis_names,
                                     devices=np.empty(layout.shape))
        got, want = (mesh.rules_for(tget(arch), layout),
                     ref.rules_for(get_config(arch), fake))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.dp_size, got.ep_size, got.tp_size) == \
            (want.dp_size, want.ep_size, want.tp_size)
    host = mesh.make_host_mesh()
    got = mesh.rules_for(tget(arch), host)
    want = ref.rules_for(get_config(arch), ref.make_host_mesh())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", all_arch_names())
def test_batch_shapes_and_specs_match_reference(arch):
    from repro.configs import get_config
    from repro.launch import mesh as ref_mesh
    from repro.models import api as ref
    cfg, rcfg = tget(arch), get_config(arch)
    layout = mesh.make_production_mesh()
    rules = mesh.rules_for(cfg, layout)
    rrules = ref_mesh.rules_for(rcfg, types.SimpleNamespace(
        axis_names=layout.axis_names, devices=np.empty(layout.shape)))
    for shape in ("train_4k", "prefill_32k"):
        got = api.batch_shapes(cfg, SHAPES[shape])
        want = ref.batch_shapes(rcfg, SHAPES[shape])
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert str(got[k].dtype).split(".")[-1] == str(v.dtype)
        gs = api.batch_specs(cfg, rules, SHAPES[shape].global_batch)
        ws = ref.batch_specs(rcfg, rrules, SHAPES[shape].global_batch)
        # PartitionSpec writes a one-axis tuple as the axis
        one = lambda a: a[0] if isinstance(a, tuple) and len(a) == 1 \
            else a  # noqa: E731
        assert {k: tuple(map(one, v)) for k, v in ws.items()} == \
            {k: tuple(map(one, v)) for k, v in gs.items()}


@pytest.mark.parametrize("key", sorted(json.load(open(REF))["cells"]))
def test_smoke_flops_match_reference(smoke_cells, key):
    """The port's smoke cell within 1% of the reference's dot FLOPs (equal
    in the run of record); kernel 7's backward recomputes the QK product
    as the reference's checkpointed chunk body does, a term named apart.
    A cell the reference could not run is recorded as such, and the
    port's runs."""
    ref = reference_doc()["cells"][key]
    got = smoke_cells[key]
    assert got["status"] == "ok" and got["n_devices"] == 1
    if ref["status"] != "ok":
        assert key in reference_doc()["not_run"] and ref["error"]
        assert got["hlo"]["flops_per_device"] > 0
        return
    want = ref["hlo"]["flops_per_device"]
    flops = got["hlo"]["flops_per_device"]
    assert abs(flops - want) <= FLOP_REL * want, (flops, want)
    recompute = got["hlo"]["attention_recompute_flops"]
    assert (recompute > 0) == (got["shape"] == "train_4k")


def test_smoke_artifact_meets_the_reference_contract(tmp_path):
    """``test_dryrun_smoke_artifact_consistent``'s checks on a port smoke
    artifact written and read back."""
    cell = dryrun.run_cell("yi-6b", "train_4k", "single", smoke=True)
    path = dryrun.cell_path("yi-6b", "train_4k", "single", smoke=True,
                            base=str(tmp_path))
    with open(path, "w") as f:
        json.dump(cell, f, default=str)
    with open(path) as f:
        cell = json.load(f)
    assert cell["status"] == "ok" and cell.get("smoke") is True
    assert cell["n_devices"] >= 1
    r = cell["roofline"]
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert r["collective_s"] >= 0
    assert r["bottleneck"] in ("compute_s", "memory_s", "collective_s")
    mem = cell["memory"]
    assert mem["peak_per_device_bytes"] > 0
    assert mem["temp_bytes"] >= 0
    hlo = cell["hlo"]
    assert hlo["flops_per_device"] > 0 and hlo["hbm_bytes_per_device"] > 0
    assert "total" in hlo["collectives"]
    mf = cell["model_flops"]
    assert 0 < mf["n_active_params"] <= mf["n_params"]
    assert mf["model_flops_per_device"] > 0
    assert cell["dense_tp"] is False and "note" in cell["xla_cost_analysis"]
    assert roofline.analyze_cell(cell, roofline.H100)["fits_hbm"]


def _count(low, chunk):
    counter = hlo_stats.StepCounter(attn_chunk=chunk, records=low.records)
    with counter:
        counter.arguments(low.arguments)
        out = low.run()
    return counter.result(out)


def test_variant_cells_count_or_refuse_sequence_sharding():
    """``--variant opt``: an arch whose overrides leave ``seq_shard`` off
    (falcon-mamba-7b's SSM) counts as its base cell does; a ``seq_shard``
    one (kimi-k2's ep_sp + seq_shard) is a skip naming it, and
    ``lower_cell`` refuses it rather than count S / tp tokens a rank."""
    from repro_torch.configs.opt_variants import apply_variant
    got = dryrun.run_cell("falcon-mamba-7b", "train_4k", "single", "opt",
                          smoke=True)
    base = dryrun.run_cell("falcon-mamba-7b", "train_4k", "single",
                           smoke=True)
    assert got["status"] == "ok" and got["dense_tp"] is False
    assert got["hlo"]["flops_per_device"] == base["hlo"]["flops_per_device"]
    kimi = dryrun.run_cell("kimi-k2-1t-a32b", "train_4k", "single", "opt",
                           smoke=True)
    assert kimi["status"] == "skip" and "seq_shard" in kimi["reason"]
    cfg = apply_variant(tget("kimi-k2-1t-a32b"), "opt").reduced()
    layout = mesh.make_host_mesh()
    with pytest.raises(NotImplementedError, match="seq_shard"):
        lower_cell(cfg, SHAPES["train_4k"], layout,
                   mesh.rules_for(cfg, layout))


def test_full_width_phi3_prefill_counts_in_seconds_as_the_cpu_path():
    """phi3-mini's full-width, full-depth prefill_32k rank program (2 x
    32,768 tokens) counted on meta in seconds, its kernel-7 FLOPs by the
    chunk formula; and at a reduced width the meta count equals
    FlopCounterMode's count of the same prefill run on the CPU's plain
    path (S a multiple of the chunk, so nothing is padded)."""
    cfg = tget("phi3-mini-3.8b")
    layout = mesh.make_production_mesh()
    t0 = time.time()
    low = lower_cell(cfg, SHAPES["prefill_32k"], layout,
                     mesh.rules_for(cfg, layout))
    stats = _count(low, cfg.attn_chunk)
    assert time.time() - t0 < 30
    assert stats["kernel_calls"] == {"flash_attention": cfg.n_layers}
    units = hlo_stats.attention_units(2, 32768, 32768, cfg.n_heads,
                                      cfg.resolved_head_dim, cfg.attn_chunk)
    assert stats["flops_kernels"] == 4 * units * cfg.n_layers
    # reduced width: meta == the CPU plain path
    small = dataclasses.replace(cfg.reduced(), attn_chunk=16)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=2)
    host = mesh.make_host_mesh()
    low = lower_cell(small, shape, host, mesh.rules_for(small, host))
    meta = _count(low, small.attn_chunk)
    from repro_torch import convert
    from repro_torch.models.layers import numpy_params
    from torch.utils.flop_counter import FlopCounterMode
    model = api.build_model(small, device="cpu").load_params(
        convert.lm_params_from_jax(numpy_params(small, 0), small))
    tok = torch.zeros(2, 64, dtype=torch.int64)
    with FlopCounterMode(display=False,
                         custom_mapping=hlo_stats.FLOP_MAPPING) as fc:
        model.prefill({"tokens": tok})
    assert meta["flops"] == fc.get_total_flops() > 0


def test_production_moe_records_its_collectives():
    """Reduced grok-1 (2d) on the (16, 16) layout: the FSDP gathers, the
    TP psum and reduce-scatter, the final gather and the dp mean of the
    aux loss are recorded on 16-rank stand-ins with the ring wire bytes;
    each rank holds (E, d / 16, f / 16) of every expert leaf."""
    cfg = tget("grok-1-314b").reduced()
    layout = mesh.make_production_mesh()
    rules = mesh.rules_for(cfg, layout)
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=64,
                                global_batch=32)
    low = lower_cell(cfg, shape, layout, rules)
    w1 = dict(low.model.named_parameters())["layers.0.ffn.w1"]
    assert tuple(w1.shape) == (cfg.n_experts, cfg.d_model // 16,
                               cfg.d_ff // 16)
    stats = _count(low, cfg.attn_chunk)
    kinds = stats["collectives"]["per_kind"]
    assert {"all-gather", "all-reduce", "reduce-scatter"} <= set(kinds)
    assert all(r["group_size"] == 16 for r in low.records)
    for r in low.records:
        assert r["site"].startswith("models.")
    total = sum(hlo_stats.wire_bytes(r["kind"], r["operand_bytes"],
                                     r["result_bytes"], 16)
                for r in low.records)
    assert stats["collectives"]["total"]["wire_bytes"] == total > 0


def test_stand_in_group_is_meta_only():
    g = collectives.StandInGroup(4)
    with pytest.raises(ValueError, match="meta"):
        collectives.all_gather(torch.zeros(3), g)
    out = collectives.all_gather(torch.empty(3, device="meta"), g)
    assert tuple(out.shape) == (4, 3) and g.records[0]["kind"] == \
        "all-gather"
