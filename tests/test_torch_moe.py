"""The port's MoE family (``repro_torch.models.moe`` inside
``models/transformer.py``) against the JAX package's, on the same numpy
parameters and tokens.

The JAX side runs once, in a subprocess that sees 8 host devices
(``compat_make_mesh``: a (1, 1) mesh for the one-device runs, an (8, 1)
one for expert parallelism). The port runs the one-device models here
and kimi-k2's expert-parallel loss once, on 8 spawned CPU ranks of one
gloo group, in the reference test's configuration
(``tests/test_collectives.py``: reduced, 16 experts, top-2, capacity
factor 8, 16 x 8 tokens).
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
from repro_torch.models.layers import numpy_params  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("grok-1-314b", "kimi-k2-1t-a32b")
MODES = ("ep", "2d", "2d_full", "ep_sp")
B, S, DECODE_STEPS = 2, 16, 2
EP = 8
LOGIT_TOL = 1e-5


def arch_config(arch, **kw):
    return dataclasses.replace(tget(arch).reduced(), **kw)


def ep_config():
    return arch_config("kimi-k2-1t-a32b", n_experts=16, top_k=2,
                       capacity_factor=8.0)


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
    model = build_model(cfg, device=ctx.device,
                        group=torch.distributed.group.WORLD).load_params(
        convert.lm_params_from_jax(
            numpy_params(cfg, 0), cfg,
            expert_slice=moe.expert_slice(cfg.n_experts, ctx.rank,
                                          ctx.size)))
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


def test_tensor_parallel_moe_is_refused():
    cfg = arch_config("grok-1-314b")
    model = port_model(cfg)
    x = torch.zeros(1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match="item 15"):
        moe.moe_ffn(x, model.layers[0]["ffn"], cfg, tp_size=2)


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
