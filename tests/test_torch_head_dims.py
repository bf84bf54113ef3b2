"""The port's models at the head sizes and grouping that only some configs
bring, against the JAX package on the same numpy weights: phi3-mini's
head size 96 (G = 1), kimi-k2's 112 (G = 8, MoE) and granite-20b's
48-head MQA (G = 48). ``ArchConfig.reduced()`` sets ``head_dim=16`` and at
most 4 heads, so the other reduced-model tests never reach these; here
each reduced config keeps its own head size and grouping.

Parameters come from ``repro_torch.models.layers.numpy_params`` and reach
the port through ``convert.lm_params_from_jax``; the reference's caches
reach it through ``convert.lm_cache_from_jax``. On the CPU the port runs
kernel 7 as its plain version, whose head-size-free specification the
CUDA sources follow (``tests/test_torch_flash_attention.py`` holds it at
these sizes).

Tolerance: logits and caches within 2e-6 relative to the largest value,
as ``tests/test_torch_lm.py`` (float32, summation order only). The
committed full-width rows of phi3-mini (``jax_dense_reference.json``,
2 layers, float32, two 1,280-token prompts) are held within
``chip_smoke.py``'s DENSE_TOL of 1e-4: the port's plain path is 3.4e-5 to
4.7e-5 from them, float32 summation order at d_model 3072 and the
reference's compiled float32 rope at long positions, while a 0.1% error in
the attention scale moves them 6.2e-3.
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
from repro.launch.mesh import compat_make_mesh, rules_for  # noqa: E402
from repro.models.api import build_model as jbuild  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import numpy_params  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

REL = 2e-6
DENSE_TOL = 1e-4
B, S, DECODE_STEPS = 2, 24, 2
DENSE_REFERENCE = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                               "bench_cache_torch", "jax_dense_reference.json")

# (arch, overrides of reduced()): the config's head size and grouping
VARIANTS = {
    "phi3-mini D=96": ("phi3-mini-3.8b",
                       dict(head_dim=96, n_heads=2, n_kv_heads=2)),
    "kimi-k2 D=112 G=8": ("kimi-k2-1t-a32b",
                          dict(head_dim=112, n_heads=8, n_kv_heads=1,
                               n_experts=8, top_k=2)),
    "granite-20b G=48": ("granite-20b", dict(n_heads=48, n_kv_heads=1)),
}


def _configs(arch, over):
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(tget(arch).reduced(), **over))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= rel, f"relative error {err:.3g} > {rel}"


def test_the_variants_keep_the_configs_heads():
    """Each variant keeps its full config's grouping G = H / KH, phi3-mini
    and kimi-k2 their head size too, and the kernels take each size."""
    for arch, over in VARIANTS.values():
        full = tget(arch)
        red = dataclasses.replace(full.reduced(), **over)
        assert (red.n_heads // red.n_kv_heads
                == full.n_heads // full.n_kv_heads), arch
        assert full.resolved_head_dim in tfa.HEAD_DIMS, arch
        assert red.resolved_head_dim in tfa.HEAD_DIMS, arch
        if "head_dim" in over:
            assert red.resolved_head_dim == full.resolved_head_dim, arch


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_match_jax(variant):
    """Prefill logits and caches, then two decode steps from the
    reference's own cache (grown for them), logits and caches."""
    arch, over = VARIANTS[variant]
    jcfg, tcfg = _configs(arch, over)
    params = numpy_params(tcfg, 0)
    mesh = compat_make_mesh((1, 1), ("data", "model"))
    jm = jbuild(jcfg, rules_for(jcfg, mesh), mesh)
    jp = jax.tree.map(jnp.asarray, params)
    tm = build_model(tcfg, device="cpu").load_params(
        convert.lm_params_from_jax(params, tcfg))
    toks = np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S + DECODE_STEPS)).astype(np.int32)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :S]).long()})
    with jax.set_mesh(mesh):
        jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :S])})
        assert tl.shape == (B, tcfg.vocab_padded)
        _close(tl.numpy(), jl)
        got = convert.lm_cache_to_jax(tc)
        assert set(got) == set(jc)
        for k, v in jc.items():
            assert got[k].shape == v.shape, k
            _close(got[k], v)
        pad = ((0, 0), (0, 0), (0, DECODE_STEPS), (0, 0), (0, 0))
        jc = {k: jnp.pad(v, pad) for k, v in jc.items()}
        tc = convert.lm_cache_from_jax(jax.tree.map(np.asarray, jc))
        for t in range(DECODE_STEPS):
            tok = toks[:, S + t:S + t + 1]
            jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(S + t))
            tl, tc = tm.decode(tc, torch.as_tensor(tok).long(), S + t)
            _close(tl.numpy(), jl)
        got = convert.lm_cache_to_jax(tc)
        for k, v in jc.items():
            _close(got[k], v)


@pytest.mark.usefixtures("one_thread")
def test_plain_path_matches_committed_dense_reference():
    """The port's plain path at the dense rows' exact config (phi3-mini,
    full width, 2 layers, float32, head size 96): prefill and 8
    teacher-forced decode steps against ``jax_dense_reference.json``."""
    with open(DENSE_REFERENCE) as f:
        ref = json.load(f)
    r = pt_serve.DENSE_REFERENCE
    cfg = pt_serve.reference_config(r)
    assert ref["config"]["name"] == cfg.name
    assert cfg.resolved_head_dim == 96
    prompts = np.array(ref["prompts"], np.int64)
    np.testing.assert_array_equal(prompts, pt_serve.reference_prompts(cfg, r))
    probe = np.array(ref["probe_ids"])
    model = build_model(cfg, device="cpu").load_params(
        convert.lm_params_from_jax(
            numpy_params(cfg, ref["config"]["param_seed"]), cfg))
    logits, cache = model.prefill({"tokens": torch.as_tensor(prompts)})
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, r["decode_steps"]))
             for k, v in cache.items()}
    S0 = prompts.shape[1]
    for t, want in enumerate(ref["steps"]):
        res = pt_serve.reference_errors(logits.numpy(), want, probe,
                                        DENSE_TOL)
        assert res["max_abs_err"] <= DENSE_TOL, (t, res)
        assert not res["greedy_mismatch"], (t, res)
        if t + 1 < len(ref["steps"]):
            tok = torch.as_tensor([[w["token"]] for w in want])
            logits, cache = model.decode(cache, tok, S0 + t)
