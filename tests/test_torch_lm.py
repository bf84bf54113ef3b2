"""The port's LM serve path against the JAX package: parameters, the
decoder's prefill and decode, the batched server, and the committed
full-width reference rows, on the same numpy-made weights.

Parameters come from ``repro_torch.models.layers.numpy_params`` and reach
the port through ``convert.lm_params_from_jax``; the reference's caches
reach it through ``convert.lm_cache_from_jax``. On the CPU the port runs
kernels 6 and 7 as their plain versions.

Tolerances. Reduced models (``ArchConfig.reduced()``, float32): logits
within 2e-6 relative to the largest logit; the measured gap is at most
2.4e-7, float summation order. A sliding window one key too wide moves
the windowed variant's prefill logits by 1.4e-2 relative. The committed
full-width reference (hymba-1.5b, 2 layers, float32): 6e-6 absolute on
the stored logits and logsumexps; the port's plain path is 3.1e-6 from
JAX on the CPU, while A scaled by 0.999 in the scan moves them by 1.2e-5
and a window one key too wide by 2.5e-2.
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
from repro.models.layers import single_device_rules  # noqa: E402
from repro.runtime.serve import BatchedServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import init_params, numpy_params  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

REL = 2e-6
REF_ATOL = 6e-6
REFERENCE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                         "bench_cache_torch", "jax_lm_reference.json")

# (arch, overrides of reduced(), prompt length): reduced hymba has one KV
# head per query head, so a GQA variant with a 32-token window and a
# 48-token prompt crosses the window; yi-6b is the dense branch and
# falcon-mamba the pure-SSM one
VARIANTS = {
    "hymba": ("hymba-1.5b", {}, 16),
    "hymba-gqa-window": ("hymba-1.5b", dict(n_heads=4, n_kv_heads=2), 48),
    "yi": ("yi-6b", {}, 16),
    "falcon-mamba": ("falcon-mamba-7b", {}, 16),
}


def _configs(arch, over):
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


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


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    arch, over, S = VARIANTS[variant]
    jcfg, tcfg = _configs(arch, over)
    jm, jp, tm = _models(jcfg, tcfg)
    steps = 3
    toks = _tokens(tcfg, 2, S + steps)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :S]).long()})
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_padded)
    _close(tl.numpy(), jl)
    got = convert.lm_cache_to_jax(tc)
    assert set(got) == set(jc)
    for k, v in jc.items():
        assert got[k].shape == v.shape, k
        if k == "slot_pos":
            np.testing.assert_array_equal(got[k], np.asarray(v))
        else:
            _close(got[k], v)
    # decode from the reference's own cache, grown along the sequence for
    # a full-attention model as the servers do
    if not jcfg.sliding_window and "k" in jc:
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
        if k != "slot_pos":
            _close(got[k], v)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_make_cache_matches_the_reference_shapes(variant):
    arch, over, _ = VARIANTS[variant]
    jcfg, tcfg = _configs(arch, over)
    want = jbuild(jcfg, single_device_rules(), None).cache_shapes(3, 40)
    got = build_model(tcfg, device="cpu").make_cache(3, 40)
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        assert str(got[k].dtype).split(".")[-1] == str(v.dtype), k
        assert not got[k].any(), k


@pytest.mark.parametrize("arch", ["hymba-1.5b", "yi-6b", "falcon-mamba-7b"])
def test_numpy_params_match_the_reference_tree(arch):
    """numpy_params draws the reference's own tree: the same names and
    shapes as ``model.init``, ones and zeros where it declares them."""
    jcfg, tcfg = _configs(arch, {})
    jinit = jbuild(jcfg, single_device_rules(), None).init(
        jax.random.PRNGKey(0))
    mine = numpy_params(tcfg, 0)
    flat_j = jax.tree_util.tree_leaves_with_path(jinit)
    flat_m = dict(jax.tree_util.tree_leaves_with_path(mine))
    assert [p for p, _ in flat_j] == list(flat_m)
    for path, v in flat_j:
        assert flat_m[path].shape == v.shape, path
        if float(jnp.std(v)) == 0.0:  # ones / zeros
            np.testing.assert_array_equal(flat_m[path], np.asarray(v))


def test_init_params_follow_the_declarations():
    cfg = tget("hymba-1.5b").reduced()
    gen = torch.Generator().manual_seed(0)
    state = init_params(cfg, gen, torch.float32, "cpu")
    want = convert.lm_params_from_jax(numpy_params(cfg, 0), cfg)
    assert set(state) == set(want)
    for k, v in want.items():
        assert state[k].shape == v.shape and state[k].dtype == v.dtype, k
        if float(v.std()) == 0.0:
            assert torch.equal(state[k], v), k
    # declared std 0.02 for the token embedding, 0.1 for the conv weights
    assert abs(float(state["embed.tok"].std()) - 0.02) < 0.002
    assert abs(float(state["layers.0.ssm.conv_w"].std()) - 0.1) < 0.02
    again = init_params(cfg, torch.Generator().manual_seed(0), None, "cpu")
    assert torch.equal(again["embed.tok"], state["embed.tok"])


def test_build_model_refuses_unported_families():
    """A family neither package has is refused by name; every family of
    the registry builds (the VLM and encoder-decoder ones:
    tests/test_torch_vlm.py, tests/test_torch_encdec.py)."""
    cfg = dataclasses.replace(tget("yi-6b").reduced(), family="diffusion")
    with pytest.raises(NotImplementedError, match="diffusion"):
        build_model(cfg, device="cpu")


# ------------------------------------------------------------------ serving


@pytest.fixture(scope="module")
def server():
    _, tcfg = _configs("yi-6b", {})
    tm = build_model(tcfg, device="cpu").load_params(
        convert.lm_params_from_jax(numpy_params(tcfg, 0), tcfg))
    return BatchedServer(tm, max_batch=4, max_seq=64)


def test_serve_greedy_deterministic(server):
    p = np.arange(1, 9, dtype=np.int32)
    server.submit(p, max_new_tokens=8)
    server.submit(p, max_new_tokens=8)
    server.run_until_drained()
    a, b = server.done[-2], server.done[-1]
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.finish_reason == "length"
    assert len(a.tokens) == 8


def test_serve_batch_equals_solo(server):
    """A request's greedy output must not depend on its batch companions
    (same prompt length -> no padding interference)."""
    p1 = np.arange(1, 9, dtype=np.int32)
    p2 = np.arange(20, 28, dtype=np.int32)
    server.submit(p1, max_new_tokens=6)
    server.run_until_drained()
    solo = server.done[-1].tokens.copy()
    server.submit(p1, max_new_tokens=6)
    server.submit(p2, max_new_tokens=6)
    server.run_until_drained()
    batched = next(r for r in server.done[-2:]
                   if np.array_equal(r.prompt, p1)).tokens
    np.testing.assert_array_equal(solo, batched)


def test_serve_throughput_counters(server):
    n0, w0 = server.stats.requests_done, server.stats.waves
    for _ in range(6):  # > max_batch forces multiple waves
        server.submit(np.arange(4, dtype=np.int32), max_new_tokens=4)
    server.run_until_drained()
    st = server.stats
    assert st.requests_done == n0 + 6 and st.waves == w0 + 2
    assert st.tokens_per_s > 0 and st.nonfinite_logits == 0
    assert len(st.prefill_s) == len(st.decode_s) == len(st.decode_calls) \
        == st.waves
    assert st.decode_calls[-2:] == [3, 3]  # 4 tokens: prefill + 3 decodes


def test_serve_greedy_matches_the_jax_server():
    """Two waves of mixed prompt lengths (right-padding, the shared decode
    position, the ring cache past the window) give JAX's greedy tokens."""
    jcfg, tcfg = _configs("hymba-1.5b", dict(n_heads=4, n_kv_heads=2))
    jm, jp, tm = _models(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (40, 24, 12, 30, 9)]
    servers = (JServer(jm, jp, max_batch=3, max_seq=64),
               BatchedServer(tm, max_batch=3, max_seq=64))
    for s in servers:
        for i, p in enumerate(prompts):
            s.submit(p, max_new_tokens=6 if i != 1 else 3)
        s.run_until_drained()
    jdone, tdone = servers[0].done, servers[1].done
    assert [r.uid for r in tdone] == [r.uid for r in jdone]
    for a, b in zip(jdone, tdone):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.finish_reason == a.finish_reason
    assert servers[1].stats.waves == servers[0].stats.waves == 2


def test_serve_temperature_sampling_is_seeded():
    _, tcfg = _configs("yi-6b", {})
    tm = build_model(tcfg, device="cpu").load_params(
        convert.lm_params_from_jax(numpy_params(tcfg, 0), tcfg))
    runs = []
    for seed in (5, 5, 6):
        s = BatchedServer(tm, max_batch=2, max_seq=64, seed=seed)
        s.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=12,
                 temperature=5.0)
        s.run_until_drained()
        runs.append(s.done[0].tokens)
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


# ----------------------------------------------------- committed reference


@pytest.mark.usefixtures("one_thread")
def test_plain_path_matches_committed_reference():
    """The port's plain path on the CPU at the reference's exact config
    (full width, 2 layers, float32): prefill and 8 teacher-forced decode
    steps against ``jax_lm_reference.json``."""
    with open(REFERENCE) as f:
        ref = json.load(f)
    cfg = pt_serve.reference_config()
    assert ref["config"]["name"] == cfg.name
    assert ref["config"]["vocab_padded"] == cfg.vocab_padded
    prompts = np.array(ref["prompts"], np.int64)
    np.testing.assert_array_equal(prompts, pt_serve.reference_prompts(cfg))
    probe = np.array(ref["probe_ids"])
    model = build_model(cfg, device="cpu").load_params(
        convert.lm_params_from_jax(
            numpy_params(cfg, ref["config"]["param_seed"]), cfg))
    logits, cache = model.prefill({"tokens": torch.as_tensor(prompts)})
    S = prompts.shape[1]
    for t, want in enumerate(ref["steps"]):
        res = pt_serve.reference_errors(logits.numpy(), want, probe,
                                        REF_ATOL)
        assert res["max_abs_err"] <= REF_ATOL, (t, res)
        assert not res["greedy_mismatch"], (t, res)
        if t + 1 < len(ref["steps"]):
            tok = torch.as_tensor([[w["token"]] for w in want])
            logits, cache = model.decode(cache, tok, S + t)
