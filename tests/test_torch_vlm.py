"""The port's VLM family (internvl2's backbone: patches before the text)
against the JAX package: the parameter tree, prefill (logits and the KV
cache over patches and text), decode at positions that count the patches,
the loss (the patch positions dropped) and its gradient; and the port's
batched server, held to its own prefill of the grown prompt.

Parameters come from ``repro_torch.models.layers.numpy_params`` through
``convert.lm_params_from_jax``; patches are standard normal from a numpy
seed. The JAX side runs as ``tests/test_arch_smoke.py`` runs it. On the
CPU the port runs kernel 7 as its plain version.

The reference's server does not pad a VLM's KV cache (it pads only a
cache as long as the prompt, and a VLM's holds the patches too), so its
decoded tokens after the first are not a reference: the port's server is
held to JAX only on its first token (the prefill's), and after that to
its own prefill of the prompt grown by the tokens it decoded.

Tolerances. Reduced models (``ArchConfig.reduced()``, float32): logits
and caches within 2e-6 relative to the largest value (measured at most
2.2e-7, float summation order); the loss within 1e-6 absolute (measured
4.8e-7); each gradient leaf within 1e-5 of its largest magnitude
(measured 6.6e-7); a decode step against the prefill of the grown prompt
within 2e-6 of the largest logit (the same function, summed in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro.models.layers import single_device_rules  # noqa: E402
from repro.runtime.serve import BatchedServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import numpy_params  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.runtime.serve import BatchedServer  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

REL = 2e-6
LOSS_ABS = 1e-6
GRAD_REL = 1e-5

# overrides of reduced(): internvl2 reduced has one KV head a query head;
# the GQA variant reads two query heads a KV head, as the full model's 8
VARIANTS = {"internvl2": {}, "internvl2-gqa": dict(n_heads=4, n_kv_heads=2)}


def _configs(over):
    return (dataclasses.replace(get_config("internvl2-76b").reduced(),
                                **over),
            dataclasses.replace(tget("internvl2-76b").reduced(), **over))


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
    patches = rng.standard_normal(
        (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return toks, patches


def test_build_model_builds_the_vlm_family():
    jcfg, tcfg = _configs({})
    model = build_model(tcfg, device="cpu")
    assert isinstance(model, DecoderLM) and tcfg.family == "vlm"
    want = jbuild(jcfg, single_device_rules(), None).cache_shapes(3, 40)
    got = model.make_cache(3, 40)
    assert set(got) == set(want) == {"k", "v"}
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
    jinit = jbuild(jcfg, single_device_rules(), None).init(
        jax.random.PRNGKey(0))
    mine = numpy_params(tcfg, 0)
    assert [p for p, _ in jax.tree_util.tree_leaves_with_path(jinit)] == \
        [p for p, _ in jax.tree_util.tree_leaves_with_path(mine)]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    jcfg, tcfg = _configs(VARIANTS[variant])
    jm, jp, tm = _models(jcfg, tcfg)
    S, steps, P = 12, 3, tcfg.n_frontend_tokens
    toks, patches = _inputs(tcfg, 2, S + steps)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S]),
                             "patches": jnp.asarray(patches)})
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :S]),
                         "patches": torch.as_tensor(patches)})
    assert tl.dtype == torch.float32 and tl.shape == (2, tcfg.vocab_padded)
    _close(tl.numpy(), jl)
    got = convert.lm_cache_to_jax(tc)
    assert set(got) == set(jc)
    for k, v in jc.items():
        assert got[k].shape == v.shape and v.shape[2] == P + S, k
        _close(got[k], v)
    # decode from the reference's cache grown from its real length, at
    # positions that count the patches
    pad = ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0))
    jc = {k: jnp.pad(v, pad) for k, v in jc.items()}
    tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc))
    for t in range(steps):
        tok = toks[:, S + t:S + t + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(P + S + t))
        tl, tc = tm.decode(tc, torch.as_tensor(tok).long(), P + S + t)
        _close(tl.numpy(), jl)
    got = convert.lm_cache_to_jax(tc)
    for k, v in jc.items():
        _close(got[k], v)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradient_match_jax(variant):
    jcfg, tcfg = _configs(VARIANTS[variant])
    jm, jp, tm = _models(jcfg, tcfg, seed=2)
    toks, patches = _inputs(tcfg, 2, 10, seed=5)
    labels = toks.copy()
    labels[1, -2:] = -1  # masked labels
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "patches": jnp.asarray(patches)}
    jloss, jgrad = jax.value_and_grad(lambda p: jm.loss(p, jb)[0])(jp)
    tm.requires_grad_(True)
    tloss, _ = tm.loss({"tokens": torch.as_tensor(toks),
                        "labels": torch.as_tensor(labels),
                        "patches": torch.as_tensor(patches)})
    tloss.backward()
    assert abs(float(tloss.detach()) - float(jloss)) <= LOSS_ABS
    want = convert.lm_params_from_jax(jax.tree.map(np.asarray, jgrad), tcfg)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    for k, w in want.items():
        err = float((got[k].grad - w).abs().max())
        assert err <= GRAD_REL * max(float(w.abs().max()), 1e-30), (k, err)


@pytest.mark.usefixtures("one_thread")
def test_server_decode_matches_its_own_prefill():
    """The port's server over zero patches: its first tokens equal the
    JAX server's (the prefill's), and each of 4 decode steps equals the
    greedy token and logits of a fresh prefill of the prompt grown by the
    tokens decoded before it. A wave of two prompt lengths decodes at the
    padded length, as the server does."""
    jcfg, tcfg = _configs(VARIANTS["internvl2-gqa"])
    jm, jp, tm = _models(jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32)
               for n in (12, 7)]
    steps = 4
    server = BatchedServer(tm, max_batch=2, max_seq=48)
    jserver = JServer(jm, jp, max_batch=2, max_seq=48)
    for s in (server, jserver):
        for p in prompts:
            s.submit(p, max_new_tokens=steps + 1)
        s.run_until_drained()
    assert server.stats.waves == 1 and server.stats.decode_calls == [steps]
    for a, b in zip(jserver.done, server.done):
        assert b.tokens[0] == a.tokens[0]
    gen = np.stack([r.tokens for r in server.done])  # (2, steps + 1)
    assert gen.shape == (2, steps + 1)
    batch = server.make_batch_inputs(server.done, 12)
    assert batch["patches"].shape == (2, tcfg.n_frontend_tokens,
                                      tcfg.d_model)
    assert not batch["patches"].any()
    logits, cache = tm.prefill(batch)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, steps))
             for k, v in cache.items()}
    P = tcfg.n_frontend_tokens
    for t in range(steps):
        tok = torch.as_tensor(gen[:, t:t + 1]).long()
        logits, cache = tm.decode(cache, tok, P + 12 + t)
        grown = dict(batch, tokens=torch.cat(
            [batch["tokens"], torch.as_tensor(gen[:, :t + 1]).long()], 1))
        want, _ = tm.prefill(grown)
        _close(logits.numpy(), want.numpy())
        np.testing.assert_array_equal(logits.argmax(-1).numpy(),
                                      gen[:, t + 1])
