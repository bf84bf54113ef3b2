"""Int8 error-feedback gradient compression: the port's
``repro_torch.optim.compression`` (kernels 3 and 4 as their plain versions
on the CPU) against ``repro.optim.compression`` on the same numpy-made
gradient trees, and the properties ``tests/test_compression.py`` states.

Tolerance: none against the JAX functions, run eagerly as its tests run
them: quantize, dequantize and the residual are the same float32
operations in the same order, so payloads, residuals and decompressed
trees are held bit-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402


def _tree(seed=0):
    """Leaves of the shapes a model has: a matrix, a ragged vector (no
    multiple of 256), a 3-D tensor, and a leaf of zeros."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((12, 300), np.float32) * 1e-3,
            "b": rng.standard_normal(77, np.float32),
            "wq": rng.standard_normal((16, 4, 8), np.float32) * 5.0,
            "z": np.zeros((3, 256), np.float32)}


def test_ef_compress_bit_equal_to_jax_over_steps():
    g = _tree()
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    jef, tef = jcomp.init_error_feedback(jg), tcomp.init_error_feedback(tg)
    for _ in range(3):
        jpay, jef = jcomp.ef_compress(jg, jef)
        tpay, tef = tcomp.ef_compress(tg, tef)
        for k in g:
            for a, b in zip(tpay[k][:2], jpay[k][:2]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            assert tpay[k][2] == jpay[k][2] == g[k].size
            np.testing.assert_array_equal(tef[k].numpy(), np.asarray(jef[k]))
        jback = jcomp.ef_decompress(jpay, jg)
        tback = tcomp.ef_decompress(tpay, tg)
        for k in g:
            assert tback[k].shape == g[k].shape
            np.testing.assert_array_equal(tback[k].numpy(),
                                          np.asarray(jback[k]))


def test_error_feedback_telescopes():
    """sum_t dq(q(g + ef_t)) -> t*g: the residual cannot accumulate (the
    statement of tests/test_compression.py)."""
    rng = np.random.RandomState(0)
    g = {"w": torch.as_tensor(rng.randn(700).astype(np.float32) * 1e-3)}
    ef = tcomp.init_error_feedback(g)
    total = torch.zeros(700)
    T = 50
    for _ in range(T):
        payload, ef = tcomp.ef_compress(g, ef)
        total += tcomp.ef_decompress(payload, g)["w"]
    gmax = float(g["w"].abs().max())
    np.testing.assert_allclose((total / T).numpy(), g["w"].numpy(), rtol=0,
                               atol=gmax / T * 2)
    assert float(ef["w"].abs().max()) < 2 * gmax


@pytest.mark.parametrize("scale", [1e-6, 1e-2, 1e3])
def test_ef_residual_bounded(scale):
    g = {"w": torch.as_tensor(np.random.RandomState(1).randn(600)
                              .astype(np.float32) * scale)}
    ef = tcomp.init_error_feedback(g)
    for _ in range(10):
        _, ef = tcomp.ef_compress(g, ef)
    # one quantization step of (g + ef)'s largest magnitude, doubled
    bound = 2 * 2 * float(g["w"].abs().max()) / 127 + 1e-6
    assert float(ef["w"].abs().max()) < bound


def test_wire_bytes_match_jax():
    for n_elems, dtype_bytes, n in ((1_000_000, 4, 2), (51_609_600, 2, 8)):
        assert tcomp.wire_bytes(n_elems, dtype_bytes, n) == \
            jcomp.wire_bytes(n_elems, dtype_bytes, n)
    assert tcomp.wire_bytes(1_000_000)["ratio"] > 7.0


@pytest.mark.cuda
def test_ef_compress_kernels_bit_equal_to_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py compresses
    the trained hymba-1.5b's whole gradient tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    g = {k: torch.as_tensor(v).cuda() for k, v in _tree(2).items()}
    ef_k = ef_p = tcomp.init_error_feedback(g)
    for _ in range(2):
        pk, ef_k = tcomp.ef_compress(g, ef_k)
        pp, ef_p = tcomp.ef_compress(g, ef_p, core="plain")
        for k in g:
            assert all(torch.equal(a, b) for a, b in zip(pk[k][:2],
                                                         pp[k][:2]))
            assert torch.equal(ef_k[k], ef_p[k])
