"""The port's encoder-decoder (the audio family, whisper-tiny) against the
JAX package: the sinusoid table, the parameter tree and its converter,
prefill (logits and the ``k``/``v``/``xk``/``xv`` caches), decode, the
loss and its gradient, the batched server, and the committed full-width
reference rows, on the same numpy-made weights and frames.

Parameters come from ``repro_torch.models.layers.numpy_params`` and reach
the port through ``convert.lm_params_from_jax``; the reference's caches
reach it through ``convert.lm_cache_from_jax``. The JAX side runs as
``tests/test_arch_smoke.py`` runs it (``build_model`` on the CPU, no
mesh). On the CPU the port runs kernel 7 as its plain version.

Tolerances. Reduced models (``ArchConfig.reduced()``, float32): logits
and caches within 2e-6 relative to the largest value (measured at most
3.4e-7, float summation order); the loss within 1e-6 absolute (measured
4.8e-7) and each gradient leaf within 1e-5 of its largest magnitude
(measured 1.5e-6). The sinusoid table: its inverse timescales within one
float32 step (1.2e-7 relative) of JAX's, since XLA's float32 ``exp``
rounds 19 of whisper's 192 one step away from the correctly rounded value
(ATen's 2); position 1,499 scales that step to up to 1.2e-4 in the angle,
so the (1500, 384) table is held to JAX within 2e-4 and, for the order of
operations, to sin/cos in float64 of the port's own float32 angles within
1e-6 (measured 3.6e-8). The committed full-width rows (whisper-tiny, 4 + 4
layers, 1,500 frames, float32): 8e-6 absolute on the stored logits, as
the LM rows; the port's plain path is 4.2e-7 from them on the CPU.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import pt_serve  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.models.encdec import sinusoids as jsinusoids  # noqa: E402
from repro.models.layers import single_device_rules  # noqa: E402
from repro.runtime.serve import BatchedServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.encdec import EncDecLM, sinusoids  # noqa: E402
from repro_torch.models.layers import init_params, numpy_params  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

REL = 2e-6
LOSS_ABS = 1e-6
GRAD_REL = 1e-5
INV_REL = 1.2e-7
TABLE_ABS = 2e-4
EXACT_ABS = 1e-6
REF_ATOL = 8e-6
REFERENCE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                         "bench_cache_torch", "jax_reference.json")

# (overrides of reduced(), prompt length): reduced whisper has one KV head
# per query head; the GQA variant reads two query heads a KV head; a
# prompt as long as the 8 frames gives self and cross caches one length
VARIANTS = {
    "whisper": ({}, 12),
    "whisper-gqa": (dict(n_heads=4, n_kv_heads=2), 12),
    "whisper-s=f": ({}, 8),
}


def _configs(over):
    return (dataclasses.replace(get_config("whisper-tiny").reduced(), **over),
            dataclasses.replace(tget("whisper-tiny").reduced(), **over))


def _models(jcfg, tcfg, seed=0):
    params = numpy_params(tcfg, seed)
    jm = jbuild(jcfg, single_device_rules(), None)
    tm = build_model(tcfg, device="cpu").load_params(
        convert.lm_params_from_jax(params, tcfg))
    return jm, jax.tree.map(jnp.asarray, params), tm


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= rel, f"relative error {err:.3g} > {rel}"


def _inputs(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, frames


@pytest.mark.parametrize("length,channels,offset",
                         [(1500, 384, 0), (5, 384, 37), (8, 64, 0)])
def test_sinusoids_match_the_reference(length, channels, offset):
    got = sinusoids(length, channels, offset=offset)
    assert got.dtype == torch.float32 and got.shape == (length, channels)
    want = np.asarray(jsinusoids(length, channels,
                                 offset=jnp.int32(offset)))
    assert float(np.abs(got.numpy() - want).max()) <= TABLE_ABS
    # the inverse timescales, float32 as the reference forms them: one
    # float32 step of JAX's at most
    half = channels // 2
    jinv = np.asarray(jnp.exp(-np.log(1e4) / (half - 1) * jnp.arange(half)))
    lt = np.float32(-np.log(1e4) / (half - 1))
    inv32 = torch.exp(torch.tensor(lt) * torch.arange(
        half, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(inv32, jinv, rtol=INV_REL, atol=0)
    ang = (np.arange(offset, offset + length, dtype=np.float32)[:, None]
           * inv32[None]).astype(np.float64)
    exact = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    assert float(np.abs(got.numpy() - exact).max()) <= EXACT_ABS


def test_numpy_params_match_the_reference_tree():
    """numpy_params draws the reference's own tree (enc_layers,
    enc_ln_post without a layer axis, dec_layers with lnx and xattn):
    the same names and shapes as ``model.init``, ones where it declares
    them; init_params follows the same declarations."""
    jcfg, tcfg = _configs({})
    jinit = jbuild(jcfg, single_device_rules(), None).init(
        jax.random.PRNGKey(0))
    mine = numpy_params(tcfg, 0)
    flat_j = jax.tree_util.tree_leaves_with_path(jinit)
    flat_m = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert [p for p, _ in flat_j] == list(flat_m)
    for path, v in flat_j:
        assert flat_m[path].shape == v.shape, path
        if float(jnp.std(v)) == 0.0:
            np.testing.assert_array_equal(flat_m[path], np.asarray(v))
    want = convert.lm_params_from_jax(mine, tcfg)
    state = init_params(tcfg, torch.Generator().manual_seed(0),
                        torch.float32, "cpu")
    assert set(state) == set(want)
    assert "enc_ln_post" in state and "dec_layers.1.xattn.wq" in state
    for k, v in want.items():
        assert state[k].shape == v.shape, k
        if float(v.std()) == 0.0:
            assert torch.equal(state[k], v), k


def test_converter_round_trips_the_tree():
    """Reference tree -> port state dict -> the reference's layout again,
    leaf for leaf; a tree of the wrong depth is refused."""
    _, tcfg = _configs({})
    tree = numpy_params(tcfg, 3)
    state = convert.lm_params_from_jax(tree, tcfg)
    assert tuple(state["enc_layers.0.attn.wq"].shape) == tree[
        "enc_layers"]["attn"]["wq"].shape[1:]
    back = convert.nest(convert.stack_layers(state))
    flat_a = convert.flatten(tree)
    flat_b = convert.flatten(back)
    assert set(flat_a) == set(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k].numpy(), v)
    again = convert.train_state_from_jax(
        {"params": tree, "opt": {}, "step": np.int32(0)})["params"]
    assert set(again) == set(state)
    for k, v in state.items():
        assert torch.equal(again[k], v), k
    short = dict(tree, enc_layers=jax.tree.map(lambda v: v[:1],
                                               tree["enc_layers"]))
    with pytest.raises(ValueError, match="enc_layers"):
        convert.lm_params_from_jax(short, tcfg)


def test_make_cache_matches_the_reference_shapes():
    jcfg, tcfg = _configs({})
    want = jbuild(jcfg, single_device_rules(), None).cache_shapes(3, 40)
    model = build_model(tcfg, device="cpu")
    assert isinstance(model, EncDecLM)
    got = model.make_cache(3, 40)
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        assert not got[k].any(), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    over, S = VARIANTS[variant]
    jcfg, tcfg = _configs(over)
    jm, jp, tm = _models(jcfg, tcfg)
    steps = 3
    toks, frames = _inputs(tcfg, 2, S + steps)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                             "frames": jnp.asarray(frames)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :S]),
                         "frames": torch.as_tensor(frames)})
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_padded)
    _close(tl.numpy(), jl)
    got = convert.lm_cache_to_jax(tc)
    assert set(got) == set(jc) == {"k", "v", "xk", "xv"}
    for k, v in jc.items():
        assert got[k].shape == v.shape, k
        _close(got[k], v)
    # decode from the reference's own cache, the self-attention's grown
    pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
    jc = {k: jnp.pad(v, pad) if k in ("k", "v") else v
          for k, v in jc.items()}
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc))
    for t in range(steps):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(S + t))
        tl, tc = tm.decode(tc, torch.as_tensor(tok).long(), S + t)
        _close(tl.numpy(), jl)
    got = convert.lm_cache_to_jax(tc)
    for k, v in jc.items():
        _close(got[k], v)


@pytest.mark.parametrize("variant", ["whisper", "whisper-gqa"])
def test_loss_and_gradient_match_jax(variant):
    over, S = VARIANTS[variant]
    jcfg, tcfg = _configs(over)
    jm, jp, tm = _models(jcfg, tcfg, seed=2)
    toks, frames = _inputs(tcfg, 2, S, seed=5)
    labels = toks.copy()
    labels[0, :3] = -1  # masked labels
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "frames": jnp.asarray(frames)}
    (jloss, jmet), jgrad = jax.value_and_grad(
        lambda p: jm.loss(p, jb), has_aux=True)(jp)
    tm.requires_grad_(True)
    tloss, tmet = tm.loss({"tokens": torch.as_tensor(toks),
                           "labels": torch.as_tensor(labels),
                           "frames": torch.as_tensor(frames)})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_ABS
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= GRAD_REL * max(float(w.abs().max()), 1e-30), (k, err)


@pytest.mark.usefixtures("one_thread")
def test_serve_greedy_matches_the_jax_server():
    """Two waves of mixed prompt lengths over zero frames: the first
    token of every request equals the JAX server's, and so do the rest
    (greedy, the self-attention cache grown and the cross cache kept)."""
    jcfg, tcfg = _configs({})
    jm, jp, tm = _models(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (14, 8, 5, 11, 9)]
    servers = (JServer(jm, jp, max_batch=3, max_seq=48),
               BatchedServer(tm, max_batch=3, max_seq=48))
    for s in servers:
        for i, p in enumerate(prompts):
            s.submit(p, max_new_tokens=6 if i != 1 else 3)
        s.run_until_drained()
    jdone, tdone = servers[0].done, servers[1].done
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for a, b in zip(jdone, tdone):
        assert b.tokens[0] == a.tokens[0]
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.finish_reason == a.finish_reason
    st = servers[1].stats
    assert st.waves == 2 and st.nonfinite_logits == 0


@pytest.mark.usefixtures("one_thread")
def test_plain_path_matches_committed_reference():
    """The port's plain path on the CPU at the rows' exact config
    (whisper-tiny at full width and depth, float32, 1,500 frames): the
    prefill's and one decode step's logits and the loss against
    ``jax_reference.json["encdec"]``."""
    with open(REFERENCE) as f:
        ref = json.load(f)["encdec"]
    r = pt_serve.ENCDEC_REFERENCE
    cfg = pt_serve.reference_config(r)
    assert ref["config"]["name"] == cfg.name == "whisper-tiny"
    assert ref["config"]["enc_layers"] == cfg.enc_layers == 4
    assert ref["config"]["n_frontend_tokens"] == cfg.n_frontend_tokens
    prompts = np.array(ref["prompts"], np.int64)
    np.testing.assert_array_equal(prompts, pt_serve.reference_prompts(cfg, r))
    frames = torch.as_tensor(pt_serve.reference_frames(cfg, r))
    probe = np.array(ref["probe_ids"])
    model = build_model(cfg, device="cpu").load_params(
        convert.lm_params_from_jax(
            numpy_params(cfg, ref["config"]["param_seed"]), cfg))
    tokens = torch.as_tensor(prompts)
    logits, cache = model.prefill({"tokens": tokens, "frames": frames})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
             if k in ("k", "v") else v for k, v in cache.items()}
    S = prompts.shape[1]
    for t, want in enumerate(ref["steps"]):
        res = pt_serve.reference_errors(logits.numpy(), want, probe,
                                        REF_ATOL)
        assert res["max_abs_err"] <= REF_ATOL, (t, res)
        assert not res["greedy_mismatch"], (t, res)
        if t + 1 < len(ref["steps"]):
            tok = torch.as_tensor([[w["token"]] for w in want])
            logits, cache = model.decode(cache, tok, S + t)
    loss, _ = model.loss({"tokens": tokens, "labels": tokens,
                          "frames": frames})
    assert abs(float(loss) - ref["loss"]) <= REF_ATOL
