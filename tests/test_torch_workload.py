"""The port's fleet replay against the JAX package: its Threefry draws
bit for bit against ``jax.random``, the float transforms within a few
ulps, the per-seed lowering of the quick templates, the quick replay's
summaries, and the replay's own contracts (metrics on and off give the
same engine state, a padded template the same streaming leaves as alone).
Short horizons on the CPU, where kernel 1 runs its plain version."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import workload as jwl  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import workload as twl  # noqa: E402
from repro_torch.core.fabric import simulator as tsim  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

# float draws: within 2 ulp, or 1e-6 relative (erfinv, log)
FLOAT_REL = 1e-6
LOWER_REL = 1e-6
SLOWDOWN_REL = 1e-3
# the step core's tolerance (DESIGN.md section 13)
FS_TOL = dict(rtol=2e-4, atol=1.0)
SEEDS = (0, 7, 123456, 2 ** 32 - 1)
# the quick templates of benchmarks/fleet_replay.py (registry points)
QUICK = dict(n_nodes=16, short_slots=16, arrivals_mean=8.0, horizon_s=4e-3,
             tenant_bytes=float(1 << 19))


def _jkey(seed):
    return jax.random.PRNGKey(np.uint32(seed))


def _words(a):
    return np.asarray(a).astype(np.int64)


# ---------------------------------------------------------------- draws


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_are_jax_bit_for_bit(seed):
    k, tk = _jkey(seed), prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(k))
    for n in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      _words(jax.random.split(k, n)))
    for d in (1, 2, 77):
        np.testing.assert_array_equal(prng.fold_in(tk, d).numpy(),
                                      _words(jax.random.fold_in(k, d)))
    for shape in ((1,), (6,), (3, 4), (2, 3, 5), (1000,)):
        np.testing.assert_array_equal(prng.bits(tk, shape).numpy(),
                                      _words(jax.random.bits(k, shape)))


def test_threefry_batch_of_keys_draws_each_seed_alone():
    seeds = np.array(SEEDS, np.int64)
    batch = prng.bits(prng.split(prng.key(seeds), 3)[:, 1], (9,))
    for i, s in enumerate(SEEDS):
        np.testing.assert_array_equal(
            batch[i].numpy(),
            _words(jax.random.bits(jax.random.split(_jkey(s), 3)[1], (9,))))


def _close(got, want):
    """Within 2 ulp of ``want`` or FLOAT_REL relative."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    ok = (np.abs(got - want) <= 2 * ulp) \
        | (np.abs(got - want) <= FLOAT_REL * np.abs(want))
    assert ok.all(), (got[~ok][:5], want[~ok][:5])


@pytest.mark.parametrize("seed", SEEDS)
def test_float_and_integer_draws_match_jax(seed):
    k, tk = _jkey(seed), prng.key(seed)
    n = 4096
    np.testing.assert_array_equal(
        prng.uniform(tk, (n,), 0.0, 0.02).numpy(),
        np.asarray(jax.random.uniform(k, (n,), minval=0.0, maxval=0.02)))
    np.testing.assert_array_equal(
        prng.uniform(tk, (n,)).numpy(),
        np.asarray(jax.random.uniform(k, (n,))))
    _close(prng.normal(tk, (n,)).numpy(), jax.random.normal(k, (n,)))
    for p in (0.375, 0.5, 1.0):
        np.testing.assert_array_equal(
            prng.bernoulli(tk, p, (n,)).numpy(),
            np.asarray(jax.random.bernoulli(k, p, (n,))))
    logp = np.log(np.array([0.5, 0.25, 0.25])).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(tk, torch.as_tensor(logp), (n,)).numpy(),
        np.asarray(jax.random.categorical(k, jnp.asarray(logp),
                                          shape=(n,))))


# ------------------------------------------------------------- lowering


@functools.lru_cache(maxsize=None)
def _templates(system, **kw):
    spec = dict(QUICK, system=system, **kw)
    return (jwl.build_template(jwl.WorkloadSpec(**spec)),
            twl.build_template(twl.WorkloadSpec(**spec)))


def _hold_lowering(jt, tt, seeds):
    want = jwl.lower_seeds(jt, seeds)
    got = twl.lower_seeds(tt, seeds, device="cpu")
    short = jt.short_idx
    np.testing.assert_array_equal(tt.short_idx, short)
    bpi_w = np.asarray(want.bytes_per_iter)
    bpi_g = got.bytes_per_iter.numpy()
    # the same slots fire, with the same CC kinds and FCT mask
    np.testing.assert_array_equal(bpi_g[:, short] > 0, bpi_w[:, short] > 0)
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(want.kind))
    np.testing.assert_array_equal(got.fct_mask.numpy(),
                                  np.asarray(want.fct_mask))
    np.testing.assert_allclose(bpi_g, bpi_w, rtol=LOWER_REL, atol=0)
    np.testing.assert_allclose(got.flow_start.numpy(),
                               np.asarray(want.flow_start), rtol=LOWER_REL,
                               atol=0)
    return got


@pytest.mark.parametrize("system", ["cresco8", "lumi"])
def test_quick_lowering_matches_jax(system):
    jt, tt = _templates(system)
    got = _hold_lowering(jt, tt, np.arange(8))
    assert len(set(map(tuple, got.kind.numpy().tolist()))) > 1


def test_pareto_mix_lowering_matches_jax():
    jt, tt = _templates("lumi", short_pareto_frac=0.4)
    _hold_lowering(jt, tt, np.arange(8))


def test_lowering_is_batch_invariant():
    _, tt = _templates("cresco8", short_pareto_frac=0.4)
    batch = twl.lower_seeds(tt, np.arange(8), device="cpu")
    for s in (0, 5):
        one = twl.lower_seeds(tt, [s], device="cpu")
        for f in tsim.PARAM_FIELDS:
            a, b = getattr(one, f), getattr(batch, f)
            if a is not None:
                assert torch.equal(a[0], b[s]), f


# --------------------------------------------------------------- replay


@pytest.mark.usefixtures("one_thread")
def test_quick_replay_matches_jax():
    """Two quick templates, 2 seeds, a 1 ms horizon: equal sample counts
    and completions, percentiles within one bin, slowdown means within
    SLOWDOWN_REL, delivered bytes within the step core's tolerance."""
    seeds = np.arange(2)
    pairs = [_templates(s, horizon_s=1e-3) for s in ("cresco8", "lumi")]
    jout, jpad = jwl.run_replay([j for j, _ in pairs], seeds, chunk=512)
    tout, tpad = twl.run_replay([t for _, t in pairs], seeds, chunk=512,
                                device="cpu")
    want, got = jwl.summarize_replay(jout, jpad), \
        twl.summarize_replay(tout, tpad)
    bin_factor = 10.0 ** (1.0 / tmet.BINS_PER_DECADE)
    for g, w in zip(got, want):
        assert g["qdelay_samples"] == w["qdelay_samples"] > 0
        assert g["fct_samples"] == w["fct_samples"] > 0
        for metric in ("qdelay_s", "fct_s"):
            for q, v in w[metric].items():
                assert v / bin_factor <= g[metric][q] * (1 + 1e-9) \
                    and g[metric][q] <= v * bin_factor * (1 + 1e-9), \
                    (metric, q)
        assert list(g["jobs"]) == list(w["jobs"])
        for job, wj in w["jobs"].items():
            gj = g["jobs"][job]
            assert gj["completions"] == wj["completions"], job
            np.testing.assert_allclose(gj["slowdown_mean"],
                                       wj["slowdown_mean"],
                                       rtol=SLOWDOWN_REL)
    np.testing.assert_array_equal(tout["it"][..., :3],
                                  np.asarray(jout["it"])[..., :3])
    F = tout["fbytes"].shape[-1]
    np.testing.assert_allclose(tout["fbytes"],
                               np.asarray(jout["fbytes"])[..., :F], **FS_TOL)


@functools.lru_cache(maxsize=None)
def _small():
    """A small template (cresco8/8, a 150 us horizon), as the reference's
    tests/test_workload.py uses."""
    return twl.build_template(twl.WorkloadSpec(
        system="cresco8", n_nodes=8, short_slots=8, arrivals_mean=4.0,
        horizon_s=1.5e-4, tenant_bytes=float(1 << 18),
        short_bytes_median=float(64 << 10), tenant_stagger_s=20e-6))


def _run_at_dims(t, dims, seeds, metrics=True):
    tp = twl.pad_template(t, dims)
    return tsim.run_cells_hetero(
        tsim.stack_geometries([tp.geom]),
        tsim.stack_params([twl.lower_seeds(tp, seeds, "cpu")]),
        tsim.TDONE_SLOTS, chunk=64, max_chunks=twl.replay_budget(tp, 64),
        metrics=metrics, with_trace=False, device="cpu")


def _bits(x):
    x = np.ascontiguousarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def test_metrics_on_and_off_give_the_same_engine_state():
    t = _small()
    dims = tsim.geometry_dims(t.geom)
    on = _run_at_dims(t, dims, np.arange(3))
    off = _run_at_dims(t, dims, np.arange(3), metrics=False)
    for k in ("fbytes", "t", "it", "t_done", "qd_acc", "chunks"):
        np.testing.assert_array_equal(_bits(on[k]), _bits(off[k]), k)
    assert "h_qd" not in off and on["h_fct"].sum() > 0


def test_padding_inert_for_streaming_metrics():
    t = _small()
    seeds = np.arange(3)
    dims0 = tsim.geometry_dims(t.geom)
    dims1 = dataclasses.replace(
        dims0, n_links=dims0.n_links + 16, n_flows=dims0.n_flows + 32,
        n_jobs=dims0.n_jobs + 3, n_sw=dims0.n_sw + 2,
        n_src=dims0.n_src + 2)
    out0 = _run_at_dims(t, dims0, seeds)
    out1 = _run_at_dims(t, dims1, seeds)
    F, J = dims0.n_flows, dims0.n_jobs
    for k in ("t", "h_qd", "h_fct"):
        np.testing.assert_array_equal(_bits(out0[k]), _bits(out1[k]), k)
    np.testing.assert_array_equal(_bits(out0["fbytes"]),
                                  _bits(out1["fbytes"][..., :F]))
    for k in ("wn", "wmean", "wm2"):
        np.testing.assert_array_equal(_bits(out0[k]),
                                      _bits(out1[k][..., :J]), k)
    assert out1["fbytes"][..., F:].sum() == 0.0
    assert out1["wn"][..., J:].sum() == 0.0
    assert out0["h_fct"].sum() > 0
