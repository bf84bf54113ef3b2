"""The port's MoE family (``repro_torch.models.moe`` inside
``models/transformer.py``) against the JAX package's, on the same numpy
parameters and tokens.

The JAX side runs once, in a subprocess that sees 8 host devices
(``compat_make_mesh``: a (1, 1) mesh for the one-device runs, an (8, 1)
one for expert parallelism, and the (data, model) layouts of the tensor-
parallel cases). The port runs the one-device models here, kimi-k2's
expert-parallel loss once on 8 spawned CPU ranks of one gloo group, in
the reference test's configuration (``tests/test_collectives.py``:
reduced, 16 experts, top-2, capacity factor 8, 16 x 8 tokens), and every
tensor-parallel case of ``TP_CASES`` in one more spawn of 8 ranks, each
case on its layout's row and column subgroups.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import (RankGroups,  # noqa: E402
                                       numpy_params)
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
MODES = ("ep", "2d", "2d_full", "ep_sp")
B, S, DECODE_STEPS = 2, 16, 2
EP = 8
LOGIT_TOL = 1e-5
# tensor-parallel moe_ffn cases: (mode, (data, model) layout, S); the last
# one's S does not split over 8 TP ranks, so ep_sp falls back to ep
TP_CASES = (("ep", (1, 8), 16), ("ep", (2, 4), 16), ("2d", (1, 8), 16),
            ("2d", (2, 4), 16), ("2d_full", (1, 8), 16),
            ("2d_full", (2, 4), 16), ("ep_sp", (1, 8), 16),
            ("ep_sp", (2, 4), 16), ("ep_sp", (4, 2), 16),
            ("ep_sp", (1, 8), 12))
TP_B = 4
TP_STD = 0.1  # weights of this scale give outputs of order 1


def arch_config(arch, **kw):
    return dataclasses.replace(tget(arch).reduced(), **kw)


def ep_config():
    return arch_config("kimi-k2-1t-a32b", n_experts=16, top_k=2,
                       capacity_factor=8.0)


def tp_config(mode):
    """Reduced grok-1 (d 64, f 128) with 8 experts, top-2."""
    return arch_config("grok-1-314b", moe_sharding=mode, n_experts=8,
                       top_k=2)


def tp_inputs(cfg, S, seed=5):
    """x (TP_B, S, d) and the whole MoE leaves, numpy float32."""
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    draw = lambda *shape: (rng.standard_normal(shape, np.float32)  # noqa
                           * np.float32(TP_STD))
    p = {"router": draw(d, E), "w1": draw(E, d, f), "w3": draw(E, d, f),
         "w2": draw(E, f, d)}
    return rng.standard_normal((TP_B, S, d), np.float32), p


def tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def dispatch_gates():
    """(T, E) gates with exact ties (uniform rows, repeated pairs) and
    more assignments than a capacity of 8 slots takes."""
    rng = np.random.default_rng(3)
    g = rng.random((40, 4), np.float32)
    g[::5] = 0.25
    g[1::7, 2] = g[1::7, 0]
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


_JAX = r"""
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [sys.argv[2], sys.argv[3]]
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.launch.mesh import compat_make_mesh, rules_for
from repro.models import moe as jmoe
from repro.models.api import build_model
import test_torch_moe as T

out = {}
fe, sl, cw = jmoe._dispatch_indices(jnp.asarray(T.dispatch_gates()), 2, 8)
out["dispatch"] = np.stack([np.asarray(fe), np.asarray(sl)])
out["dispatch_w"] = np.asarray(cw)

def model_on(cfg, shape):
    mesh = compat_make_mesh(shape, ("data", "model"))
    return build_model(cfg, rules_for(cfg, mesh), mesh), mesh

def jcfg(tcfg):
    base = get_config(tcfg.name).reduced()
    return dataclasses.replace(base, **{
        f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
        if f.name != "source"})

for arch in T.ARCHS:
    tcfg = T.arch_config(arch)
    model, m = model_on(jcfg(tcfg), (1, 1))
    params = jax.tree.map(jnp.asarray, T.numpy_params(tcfg, 0))
    tok = T.tokens(tcfg, (T.B, T.S), 1)
    with jax.set_mesh(m):
        lg, cache = jax.jit(model.prefill)(params,
                                           {"tokens": jnp.asarray(tok)})
        loss, met = jax.jit(model.loss)(params, {"tokens": jnp.asarray(tok),
                                                 "labels": jnp.asarray(tok)})
        cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, T.DECODE_STEPS),
                                (0, 0), (0, 0)]) for k, v in cache.items()}
        steps = [np.asarray(lg)]
        decode = jax.jit(model.decode)
        for t in range(T.DECODE_STEPS):
            nxt = np.asarray(steps[-1]).argmax(-1)[:, None].astype(np.int32)
            lg, cache = decode(params, cache, jnp.asarray(nxt),
                               jnp.int32(T.S + t))
            steps.append(np.asarray(lg))
    out[arch + "/logits"] = np.stack(steps)
    out[arch + "/loss"] = np.array([float(loss), float(met["loss"]),
                                    float(met["aux_loss"])])
for mode in T.MODES:
    tcfg = T.arch_config("kimi-k2-1t-a32b", moe_sharding=mode)
    model, m = model_on(jcfg(tcfg), (1, 1))
    params = jax.tree.map(jnp.asarray, T.numpy_params(tcfg, 0))
    tok = T.tokens(tcfg, (T.B, T.S), 1)
    with jax.set_mesh(m):
        loss, met = jax.jit(model.loss)(params, {"tokens": jnp.asarray(tok),
                                                 "labels": jnp.asarray(tok)})
    out["mode/" + mode] = np.array([float(loss), float(met["aux_loss"])])
tcfg = T.ep_config()
model, m = model_on(jcfg(tcfg), (T.EP, 1))
params = jax.tree.map(jnp.asarray, T.numpy_params(tcfg, 0))
tok = T.tokens(tcfg, (16, 8), 2)
with jax.set_mesh(m):
    loss, met = jax.jit(model.loss)(params, {"tokens": jnp.asarray(tok),
                                             "labels": jnp.asarray(tok)})
out["ep8"] = np.array([float(loss), float(met["loss"]),
                       float(met["aux_loss"])])
for i, (mode, shape, S) in enumerate(T.TP_CASES):
    tcfg = T.tp_config(mode)
    cfg = jcfg(tcfg)
    x, p = T.tp_inputs(tcfg, S)
    m = compat_make_mesh(shape, ("data", "model"))
    rules = rules_for(cfg, m)
    fn = jax.jit(lambda x, p: jmoe.moe_ffn(x, p, cfg, rules, m))
    with jax.set_mesh(m):
        o, aux = fn(jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    out[f"tp{i}"] = np.asarray(o)
    out[f"tp{i}/aux"] = np.asarray(aux)
np.savez(sys.argv[1], **out)
print("JAX", jax.__version__, len(jax.devices()))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_moe") / "out.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", _JAX, path, os.path.join(ROOT, "src"),
         os.path.dirname(os.path.abspath(__file__))],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.split()[-1] == str(EP)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def port_model(cfg, seed=0, **kw):
    return build_model(cfg, device="cpu", **kw).load_params(
        convert.lm_params_from_jax(numpy_params(cfg, seed), cfg))


def test_dispatch_indices_match_reference(jax_side):
    """Equal experts and slots (ties to the lower expert, as lax.top_k;
    assignments past the capacity in slot 8) and combine weights."""
    fe, sl, cw = moe._dispatch_indices(torch.as_tensor(dispatch_gates()),
                                       2, 8)
    np.testing.assert_array_equal(np.stack([fe.numpy(), sl.numpy()]),
                                  jax_side["dispatch"])
    np.testing.assert_allclose(cw.numpy(), jax_side["dispatch_w"],
                               rtol=1e-6)
    assert (sl.numpy() == 8).any()  # some assignments dropped


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_moe_matches_reference(jax_side, arch):
    """Prefill and two greedy decode steps' logits within 1e-5 of JAX's,
    and the loss, its cross-entropy and the aux loss."""
    cfg = arch_config(arch)
    model = port_model(cfg)
    tok = torch.as_tensor(tokens(cfg, (B, S), 1))
    lg, cache = model.prefill({"tokens": tok})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, DECODE_STEPS))
             for k, v in cache.items()}
    steps = [lg]
    for t in range(DECODE_STEPS):
        nxt = steps[-1].argmax(-1)[:, None]
        lg, cache = model.decode(cache, nxt, S + t)
        steps.append(lg)
    want = jax_side[arch + "/logits"]
    got = torch.stack(steps).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL
    loss, met = model.loss({"tokens": tok, "labels": tok})
    np.testing.assert_allclose(
        [float(loss), float(met["loss"]), float(met["aux_loss"])],
        jax_side[arch + "/loss"], atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_reference(jax_side, mode):
    """With tensor parallelism 1 the four modes are one function."""
    cfg = arch_config("kimi-k2-1t-a32b", moe_sharding=mode)
    tok = torch.as_tensor(tokens(cfg, (B, S), 1))
    loss, met = port_model(cfg).loss({"tokens": tok, "labels": tok})
    np.testing.assert_allclose([float(loss), float(met["aux_loss"])],
                               jax_side["mode/" + mode], atol=LOGIT_TOL,
                               rtol=0)


def ep_rank(ctx):
    """One rank of kimi-k2's expert-parallel loss: this rank's 16 / 8
    sequences and 16 / 8 experts."""
    cfg = ep_config()
    tok = tokens(cfg, (16, 8), 2)
    per = tok.shape[0] // ctx.size
    mine = torch.as_tensor(tok[ctx.rank * per:(ctx.rank + 1) * per])
    world = torch.distributed.group.WORLD
    layout = mesh.RankLayout(("data", "model"), (ctx.size, 1))
    cut = moe.rank_slices(cfg, mesh.rules_for(cfg, layout),
                          layout.coords(ctx.rank))
    model = build_model(cfg, device=ctx.device, groups=RankGroups(
        dp=world, ep=world)).load_params(
        convert.lm_params_from_jax(numpy_params(cfg, 0), cfg,
                                   weight_slices=cut))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    loss, met = model.loss({"tokens": mine, "labels": mine})
    return [float(loss), float(met["loss"]), float(met["aux_loss"])], shapes


def test_expert_parallel_loss_matches_reference(jax_side):
    """kimi-k2 on 8 ranks (experts over the ranks, two all-to-alls a
    layer) within 1e-5 of JAX's 8-device loss; every rank the same bits;
    each rank holds 2 of the 16 experts."""
    ranks = mesh.spawn_group(ep_rank, EP, backend="gloo", device="cpu")
    losses = [r[0] for r in ranks]
    assert all(l == losses[0] for l in losses)
    np.testing.assert_allclose(losses[0], jax_side["ep8"], atol=LOGIT_TOL,
                               rtol=0)
    shapes = ranks[0][1]
    cfg = ep_config()
    assert shapes["layers.0.ffn.w1"] == (2, cfg.d_model, cfg.d_ff)
    assert shapes["layers.0.ffn.router"] == (cfg.d_model, 16)


def tp_rank(ctx):
    """Every case of ``TP_CASES`` on this rank: its layout's subgroups
    (``spawn_group``'s for (2, 4), the others made on every rank, layouts
    in one order), its share of the leaves (``moe.rank_slices``) and its
    data shard of x. Returns the (2, 4) place and subgroups
    ``spawn_group`` gave it, and per case the rank's coordinates, output,
    aux and leaf shapes."""
    dist = torch.distributed
    given = (ctx.coords, dist.get_process_group_ranks(ctx.row),
             dist.get_process_group_ranks(ctx.col))
    layouts = {(2, 4): (ctx.coords, ctx.row, ctx.col)}
    for layout in sorted({c[1] for c in TP_CASES} - {(2, 4)}):
        layouts[layout] = mesh.layout_groups(layout, ctx.rank)
    out = []
    for mode, layout, S in TP_CASES:
        coords, row, col = layouts[layout]
        cfg = tp_config(mode)
        x, p = tp_inputs(cfg, S)
        rules = mesh.rules_for(cfg, mesh.RankLayout(("data", "model"),
                                                     layout))
        cut = moe.rank_slices(cfg, rules, coords)
        mine = {k: torch.as_tensor(v[cut[k]] if k in cut else v)
                for k, v in p.items()}
        b = TP_B // layout[0]
        i = coords["data"]
        o, aux = moe.moe_ffn(torch.as_tensor(x[i * b:(i + 1) * b]), mine,
                             cfg, rules=rules,
                             groups=RankGroups(dp=col, ep=col, tp=row))
        out.append((coords, o.numpy(), float(aux),
                    {k: tuple(v.shape) for k, v in mine.items()}))
    return given, out


@pytest.fixture(scope="module")
def tp_spawn():
    return mesh.spawn_group(tp_rank, 8, backend="gloo", device="cpu",
                            layout=(2, 4))


@pytest.fixture(scope="module")
def tp_side(tp_spawn):
    return [out for _, out in tp_spawn]


def test_spawn_group_gives_layout_subgroups(tp_spawn):
    """``spawn_group(layout=(2, 4))``: rank r at (r // 4, r % 4), its row
    the 4 ranks of its data index (TP), its column the 2 of its model
    index (data and expert parallel)."""
    layout = mesh.RankLayout(("data", "model"), (2, 4))
    for r, ((coords, row, col), _) in enumerate(tp_spawn):
        assert coords == layout.coords(r) == {"data": r // 4,
                                              "model": r % 4}
        assert row == [r // 4 * 4 + j for j in range(4)]
        assert col == [i * 4 + r % 4 for i in range(2)]


def _tp_output(tp_side, case: int):
    """The case's (B, S, d) output from its ranks (each TP row's ranks
    bit-equal, rows stacked by data index) and the ranks' aux losses."""
    layout = TP_CASES[case][1]
    rows = {}
    for ranks in tp_side:
        coords, o, aux, _ = ranks[case]
        rows.setdefault(coords["data"], []).append(o)
    for outs in rows.values():
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
    assert len(rows) == layout[0]
    return (np.concatenate([rows[i][0] for i in range(layout[0])]),
            [r[case][2] for r in tp_side])


@pytest.mark.parametrize("case", range(len(TP_CASES)),
                         ids=["-".join(map(str, (c[0], *c[1], c[2])))
                              for c in TP_CASES])
def test_tensor_parallel_moe_matches_reference(jax_side, tp_side, case):
    """moe_ffn at TP above 1 on 8 gloo ranks within 1e-5 of the
    reference's moe_ffn on 8 host devices, the aux loss too; every rank
    holds only its share of the expert leaves."""
    mode, layout, S = TP_CASES[case]
    got, auxes = _tp_output(tp_side, case)
    want = jax_side[f"tp{case}"]
    assert got.shape == want.shape == (TP_B, S, tp_config(mode).d_model)
    assert 0.5 <= np.abs(want).max() <= 8  # of order 1: 1e-5 is ~float32's
    assert np.abs(got - want).max() <= LOGIT_TOL
    np.testing.assert_allclose(auxes, float(jax_side[f"tp{case}/aux"]),
                               atol=LOGIT_TOL, rtol=0)
    cfg = tp_config(mode)
    rules = mesh.rules_for(cfg, mesh.RankLayout(("data", "model"), layout))
    E, d, f = moe.expert_dims(cfg, rules)
    assert E * d * f * layout[1] <= cfg.n_experts * cfg.d_model * cfg.d_ff
    for ranks in tp_side:
        shapes = ranks[case][3]
        assert shapes["w1"] == shapes["w3"] == (E, d, f)
        assert shapes["w2"] == (E, f, d)


@pytest.mark.parametrize("case", range(len(TP_CASES)),
                         ids=["-".join(map(str, (c[0], *c[1], c[2])))
                              for c in TP_CASES])
def test_tensor_parallel_moe_is_tp1_of_folded_weights(tp_side, case):
    """Each case equals the one-rank function of ``moe.tp_fold``'s weights
    on each data shard: the TP-1 function itself for 2d_full and ep_sp,
    the reference's mixed f-blocks for ep and 2d (what chip_smoke.py's
    tp_moe phase holds the card to)."""
    mode, layout, S = TP_CASES[case]
    cfg = tp_config(mode)
    x, p = tp_inputs(cfg, S)
    tp = layout[1]
    folded = moe.tp_fold({k: torch.as_tensor(v) for k, v in p.items()},
                         cfg if S % tp == 0 or mode != "ep_sp"
                         else dataclasses.replace(cfg, moe_sharding="ep"),
                         tp)
    got, _ = _tp_output(tp_side, case)
    b = TP_B // layout[0]
    one = dataclasses.replace(cfg, d_ff=folded["w1"].shape[2])
    # ep_sp's ranks each take S / tp of the sequence (and its capacity)
    n_seq = tp if mode == "ep_sp" and S % tp == 0 else 1
    s = S // n_seq
    for i in range(layout[0]):
        for j in range(n_seq):
            o, _ = moe.moe_ffn(torch.as_tensor(
                x[i * b:(i + 1) * b, j * s:(j + 1) * s]), folded, one)
            assert np.abs(o.numpy() - got[i * b:(i + 1) * b,
                                          j * s:(j + 1) * s]).max() \
                <= LOGIT_TOL


def test_tensor_parallel_ep_and_2d_are_not_the_tp1_function(tp_side):
    """The reference's d-sliced modes add different f-blocks of the TP
    ranks: far from the TP-1 function of the same weights (not a
    rounding difference), while 2d_full is it."""
    for case, (mode, layout, S) in enumerate(TP_CASES[:6]):
        cfg = tp_config(mode)
        x, p = tp_inputs(cfg, S)
        b = TP_B // layout[0]
        want = np.concatenate([moe.moe_ffn(
            torch.as_tensor(x[i * b:(i + 1) * b]),
            {k: torch.as_tensor(v) for k, v in p.items()}, cfg)[0].numpy()
            for i in range(layout[0])])
        err = np.abs(_tp_output(tp_side, case)[0] - want).max()
        assert (err > 0.1) if mode in ("ep", "2d") else (err <= LOGIT_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_rank_share_through_convert(mode):
    """``convert.lm_params_from_jax(weight_slices=moe.rank_slices(...))``
    cuts each layer's expert leaves to the rank's (E_loc, d_loc, f_loc),
    the same values as slicing the whole leaf; the rest stays whole; a
    layer declared under those rules has that share."""
    cfg = arch_config("grok-1-314b", moe_sharding=mode, n_experts=8)
    layout = mesh.RankLayout(("data", "model"), (2, 4))
    rules = mesh.rules_for(cfg, layout)
    coords = layout.coords(6)  # data 1, model 2
    cut = moe.rank_slices(cfg, rules, coords)
    tree = numpy_params(cfg, 0)
    got = convert.lm_params_from_jax(tree, cfg, weight_slices=cut)
    E, d, f = moe.expert_dims(cfg, rules)
    for i in range(cfg.n_layers):
        for leaf in moe.EXPERT_LEAVES:
            want = tree["layers"]["ffn"][leaf][i][cut[leaf]]
            assert got[f"layers.{i}.ffn.{leaf}"].shape == want.shape
            np.testing.assert_array_equal(
                got[f"layers.{i}.ffn.{leaf}"].numpy(), want)
        assert tuple(got[f"layers.{i}.ffn.w2"].shape) == (E, f, d)
        assert tuple(got[f"layers.{i}.ffn.router"].shape) == \
            (cfg.d_model, cfg.n_experts)
    from repro_torch.models.layers import block_decls
    assert block_decls(cfg, rules)["ffn"]["w1"].shape == (E, d, f)


def test_capacity_is_the_references():
    for arch in ARCHS:
        cfg = tget(arch)
        for T in (1, 8, 16, 100, 2560, 10240):
            want = max(8, -(-int(np.ceil(
                T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)) // 8)
                * 8)
            assert moe.capacity(T, cfg) == want
    # grok-1's serve prefill: 8 x 1280 tokens, 3200 slots an expert
    assert moe.capacity(8 * 1280, tget("grok-1-314b")) == 3200


def test_moe_serves_greedy_and_deterministic():
    cfg = arch_config("grok-1-314b")
    server = BatchedServer(port_model(cfg), max_batch=4, max_seq=64)
    prompt = np.arange(1, 9, dtype=np.int32)
    for _ in range(2):
        server.submit(prompt, max_new_tokens=6)
    server.run_until_drained()
    a, b = server.done
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert len(a.tokens) == 6 and server.stats.nonfinite_logits == 0
