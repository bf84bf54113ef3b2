"""The port's streaming metrics (core/metrics.py) against the JAX
package's on seeded samples: the binning and the host-side readouts
equal, the fixed-order histogram update equal to the post-hoc
histogram bin for bin, the fixed-order Welford update within 1e-6
relative of the reference's scatter (the sums differ only in order), and
a group with no samples in a step left bit for bit as it was."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import metrics as jmet  # noqa: E402
from repro_torch.core import metrics as tmet  # noqa: E402
from repro_torch.core.fabric.simulator import source_table  # noqa: E402

WELFORD_REL = 1e-6


def _samples(seed, shape):
    """Log-uniform seconds over and past the histogram's span, with exact
    zeros mixed in. (A sample that is itself a bin edge may land on
    either side of it: log10 there is a matter of the last ulp, in XLA,
    NumPy and ATen alike.)"""
    rng = np.random.default_rng(seed)
    x = 10.0 ** rng.uniform(-9, 2, shape)
    x.flat[::17] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bin_index_matches_reference(seed):
    x = _samples(seed, (4, 257))
    want = np.asarray(jmet.bin_index(jnp.asarray(x), jnp))
    np.testing.assert_array_equal(tmet.bin_index(torch.as_tensor(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(tmet.bin_index(x),
                                  np.asarray(jmet.bin_index(x, np)))


def test_readouts_match_reference():
    rng = np.random.default_rng(3)
    h = rng.integers(0, 50, (3, tmet.NBINS)).astype(np.float32)
    h[1] = 0.0  # an empty histogram reads NaN
    got, want = tmet.percentiles(h), jmet.percentiles(h)
    assert list(got) == list(want)
    for q in want:
        np.testing.assert_array_equal(got[q], want[q])
    for a, b in zip(tmet.hist_cdf(h), jmet.hist_cdf(h)):
        np.testing.assert_array_equal(a, b)
    wn = np.array([0.0, 1.0, 5.0], np.float32)
    wmean = rng.normal(size=3).astype(np.float32)
    wm2 = rng.uniform(size=3).astype(np.float32)
    for a, b in zip(tmet.welford_finalize(wn, wmean, wm2),
                    jmet.welford_finalize(wn, wmean, wm2)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tmet.bin_edges(), jmet.bin_edges())


@pytest.mark.parametrize("seed", [0, 1])
def test_hist_add_equals_posthoc_histogram(seed):
    B, F = 3, 301
    x = _samples(seed, (B, F))
    w = (np.random.default_rng(seed + 10).uniform(size=(B, F)) < 0.6)
    h = torch.zeros((B, tmet.NBINS))
    for step in range(2):  # two steps accumulate
        h = tmet.hist_add(h, torch.as_tensor(x), torch.as_tensor(w))
    for b in range(B):
        want = 2 * jmet.np_hist(x[b], w[b].astype(np.float32))
        np.testing.assert_array_equal(h[b].numpy(), want)
        # and the reference's own streaming scatter, bin for bin
        ref = jmet.hist_add(jnp.zeros(jmet.NBINS), jnp.asarray(x[b]),
                            jnp.asarray(w[b], jnp.float32), jnp)
        np.testing.assert_array_equal(h[b].numpy(), 2 * np.asarray(ref))


def _welford_inputs(seed, B=2, F=40, J=4):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, J - 1, F).astype(np.int64)  # group J-1: empty
    sample = rng.lognormal(0.0, 0.5, (B, F)).astype(np.float32)
    weight = (rng.uniform(size=(B, F)) < 0.5).astype(np.float32)
    wn = rng.integers(0, 9, (B, J)).astype(np.float32)
    wmean = rng.uniform(1, 3, (B, J)).astype(np.float32)
    wm2 = rng.uniform(0, 2, (B, J)).astype(np.float32)
    return seg, sample, weight, wn, wmean, wm2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_welford_update_matches_reference(seed):
    seg, sample, weight, wn, wmean, wm2 = _welford_inputs(seed)
    J = wn.shape[1]
    segt = torch.as_tensor(seg)[None]
    got = tmet.welford_update(
        *(torch.as_tensor(a) for a in (wn, wmean, wm2, sample, weight)),
        segt, source_table(segt, J))
    for b in range(wn.shape[0]):
        want = jmet.welford_update(
            jnp.asarray(wn[b]), jnp.asarray(wmean[b]), jnp.asarray(wm2[b]),
            jnp.asarray(sample[b]), jnp.asarray(weight[b]),
            jnp.asarray(seg), J, jnp)
        for g, w in zip(got, want):
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(g[b].numpy(), w,
                                       rtol=WELFORD_REL, atol=0)


def test_welford_group_without_samples_is_unchanged():
    seg, sample, weight, wn, wmean, wm2 = _welford_inputs(5)
    weight[:, seg == 0] = 0.0  # group 0 has members, none weighted
    J = wn.shape[1]
    segt = torch.as_tensor(seg)[None]
    out = tmet.welford_update(
        *(torch.as_tensor(a) for a in (wn, wmean, wm2, sample, weight)),
        segt, source_table(segt, J))
    for g, before in zip(out, (wn, wmean, wm2)):
        for j in (0, J - 1):  # weighted-out and memberless
            assert np.array_equal(g[:, j].numpy().view(np.int32),
                                  before[:, j].view(np.int32))
