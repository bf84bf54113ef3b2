"""Kernel 7, flash attention, and its backward: the port's plain versions
(what a CPU tensor runs) against the JAX package's full-matrix oracle at
window 0 and its models' blockwise ``flash_attention_xla`` with a sliding
window, on the same numpy-made inputs; the backward's specification
(``ref.flash_attention_bwd``) against autograd of the plain forward and
``jax.grad`` of ``flash_attention_xla``, and ``ops.FlashAttentionFn``
against both.

The JAX package's Pallas kernel (``repro/kernels/flash_attention.py``) is
not a target here: it fails on jax 0.9, where ``pl.load`` no longer exists
(``flash_attention.py:33``; ROADMAP Queue 3).

Tolerances: float32 agrees within 2e-6 absolute (outputs of magnitude
~1; the measured gap is at most 4.8e-7, summation order only); a window
one key too wide moves outputs by 0.79 or more at these shapes. bfloat16
outputs agree within one bfloat16 step at magnitude 2 (2**-6), since
both compute in float32 and round once. Gradients: 5e-6 relative to the
largest magnitude of each (measured at most 9.4e-7); a window one key too
wide in the backward moves them by 1.3 or more at these shapes.
"""
import jax
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
GRAD_REL = 5e-6
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


# ------------------------------------------------------------- backward
# (shape, causal, window): G = 1, 2 and 5, ragged lengths, and rows with no
# live key (Sq > Skv under a window, causal or not)
BWD_CASES = [(SHAPES[0], True, 0), (SHAPES[1], True, 8),
             (SHAPES[2], True, 24), (SHAPES[3], False, 0),
             ((1, 40, 24, 4, 2, 16), True, 8),
             ((1, 50, 30, 10, 2, 16), False, 10)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def _bwd_inputs(shape, seed):
    q, k, v = _qkv(shape, seed=seed)
    do = np.random.default_rng(seed + 100).standard_normal(q.shape,
                                                           np.float32)
    return q, k, v, do


@pytest.mark.parametrize("case", BWD_CASES)
def test_plain_backward_matches_autograd_and_jax(case):
    shape, causal, window = case
    q, k, v, do = _bwd_inputs(shape, seed=4)
    tq, tk, tv, tdo = (torch.as_tensor(a) for a in (q, k, v, do))
    o, lse = tref.flash_attention(tq, tk, tv, causal=causal, window=window,
                                  return_lse=True)
    got = tref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                   window=window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tref.flash_attention(*leaves, causal=causal, window=window).backward(tdo)
    jg = jax.grad(lambda *a: jnp.sum(flash_attention_xla(
        *a, causal=causal, window=window, chunk=16) * do), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    for g, leaf, j in zip(got, leaves, jg):
        assert np.all(np.isfinite(g.numpy()))
        assert _rel(g.numpy(), leaf.grad.numpy()) <= GRAD_REL
        assert _rel(g.numpy(), j) <= GRAD_REL
    # FlashAttentionFn on the CPU runs this specification
    fn = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tops.flash_attention(*fn, causal=causal, window=window).backward(tdo)
    for g, leaf in zip(got, fn):
        assert torch.equal(g, leaf.grad)


def test_plain_lse_is_the_masked_logsumexp():
    q, k, v = (torch.as_tensor(a) for a in _qkv((1, 40, 24, 4, 2, 16), 5))
    _, lse = tref.flash_attention(q, k, v, causal=True, window=8,
                                  return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(2, 2)) / 4.0
    qp, kp = torch.arange(40)[:, None], torch.arange(24)[None]
    s = s.masked_fill(~((kp <= qp) & (kp > qp - 8)), -np.inf)
    want = torch.logsumexp(s, -1)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    live = torch.isfinite(want)
    assert float((lse[live] - want[live]).abs().max()) <= 2e-6
    assert lse.shape == (1, 4, 40) and bool((lse[..., 31:] == -np.inf).all())


def test_backward_wrapper_takes_only_cuda_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(SHAPES[0]))
    o, lse = tref.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_bwd(q, k, v, o, lse, o)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at hymba's training shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape, causal, window in BWD_CASES + [((2, 300, 300, 25, 5, 64),
                                               True, 256)]:
        q, k, v, do = (torch.as_tensor(a).cuda()
                       for a in _bwd_inputs(shape, seed=6))
        o, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        _, wl = tref.flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        live = torch.isfinite(wl)
        assert torch.equal(torch.isfinite(lse), live)
        assert float((lse[live] - wl[live]).abs().max()) <= 1e-5
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
        want = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                        window=window)
        for g, w in zip(got, want):
            assert _rel(g.cpu().numpy(), w.cpu().numpy()) <= 1e-5, shape
