"""Kernel 7, flash attention: the port's plain version (what a CPU tensor
runs) against the JAX package's full-matrix oracle at window 0 and its
models' blockwise ``flash_attention_xla`` with a sliding window, on the
same numpy-made inputs.

The JAX package's Pallas kernel (``repro/kernels/flash_attention.py``) is
not a target here: it fails on jax 0.9, where ``pl.load`` no longer exists
(``flash_attention.py:33``; ROADMAP Queue 3).

Tolerances: float32 agrees within 2e-6 absolute (outputs of magnitude
~1; the measured gap is at most 4.8e-7, summation order only); a window
one key too wide moves outputs by 0.79 or more at these shapes. bfloat16
outputs agree within one bfloat16 step at magnitude 2 (2**-6), since
both compute in float32 and round once.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models.layers import flash_attention_xla  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

F32_ATOL = 2e-6
BF16_ATOL = 2.0 ** -6

# (B, Sq, Skv, H, KH, D): G = H / KH in {1, 2, 5}, ragged lengths
SHAPES = [(2, 40, 40, 4, 4, 16), (1, 37, 37, 4, 2, 128),
          (2, 64, 64, 10, 2, 64), (1, 70, 70, 5, 1, 16)]


def _qkv(shape, seed=0, dtype=np.float32):
    B, Sq, Skv, H, KH, D = shape
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32).astype(dtype)
            for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D))]


def _port(q, k, v, **kw):
    return tops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                **kw).float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_jax_oracle(shape, causal):
    q, k, v = _qkv(shape)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_port(q, k, v, causal=causal),
                               np.asarray(want), rtol=0, atol=F32_ATOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("window", [1, 8, 24])
def test_plain_window_matches_xla_path(shape, window):
    q, k, v = _qkv(shape, seed=1)
    want = flash_attention_xla(*map(jnp.asarray, (q, k, v)), causal=True,
                               window=window, chunk=16)
    np.testing.assert_allclose(_port(q, k, v, causal=True, window=window),
                               np.asarray(want), rtol=0, atol=F32_ATOL)


def test_plain_fully_masked_rows_are_zero():
    """Sq > Skv with a window: the last queries see no key; both guards
    give 0 there."""
    q, k, v = _qkv((1, 40, 24, 4, 2, 16), seed=2)
    got = _port(q, k, v, causal=True, window=8)
    want = np.asarray(flash_attention_xla(*map(jnp.asarray, (q, k, v)),
                                          causal=True, window=8, chunk=16))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    assert np.all(got[:, 31:] == 0) and np.all(np.isfinite(got))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_bfloat16_matches_jax_oracle(causal):
    q, k, v = _qkv((2, 48, 48, 10, 2, 64), seed=3)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=BF16_ATOL)


def test_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(SHAPES[0]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="core"):
        tops.flash_attention(q, k, v, core="fast")
    assert torch.equal(tops.flash_attention(q, k, v, window=4),
                       tref.flash_attention(q, k, v, window=4))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at hymba's serve shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(2, 300, 300, 25, 5, 64), (1, 90, 90, 4, 4, 128)]:
        for window in (0, 32):
            for causal in (True, False):
                q, k, v = (torch.as_tensor(a).cuda() for a in _qkv(shape))
                got = tfa.flash_attention(q, k, v, causal=causal,
                                          window=window)
                want = tref.flash_attention(q, k, v, causal=causal,
                                            window=window)
                err = float((got - want).abs().max())
                assert err <= 1e-5, (shape, window, causal, err)
