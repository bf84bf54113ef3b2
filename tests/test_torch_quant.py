"""Kernels 3 and 4, the per-256-block int8 quantize and dequantize: the
port's plain versions (what a CPU tensor runs) against the JAX package's
jnp oracle and its Pallas kernels in interpret mode, on the same
numpy-made inputs.

Tolerance against the oracle: none. Both take max|x| exactly, divide
truly, round half to even and multiply once, so q, the scales and the
dequantized values are held bit-equal, exact .5 ties and all-zero blocks
(the 1e-12 scale) included.

Against the Pallas kernels: XLA compiles the kernel's ``max|x| / 127.0``
as ``max|x| * float32(1/127)`` (so does any ``jax.jit`` of the oracle),
which differs from the true division in the last bit of some scales (1 of
the 21 blocks of the (7, 768) case). The port follows the oracle, so a
scale is held within one float32 ulp of the kernel's, and q and the
dequantized values bit-equal wherever the scales are equal (ROADMAP Queue
3).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant as tq  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# (R, C): one block, ragged row counts, many blocks per row
SHAPES = [(1, 256), (3, 512), (7, 768), (64, 256), (130, 1024)]


def _inputs(shape, seed=0):
    """Normal values at mixed scales, an all-zero block, and a block whose
    max is 127 so that x / scale hits exact .5 ties."""
    R, C = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, C)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-6, 4, (R, 1)).astype(np.float32)
    x[0, :256] = 0.0
    if R > 1:
        x[1, :256] = np.float32(0.5) * rng.integers(-254, 255, 256)
        x[1, 0] = 127.0  # scale 1: every half-integer is a tie
    return x


def _port(x):
    q, s = tops.quantize_int8(torch.as_tensor(x))
    return q.numpy(), s.numpy(), tops.dequantize_int8(q, s).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bit_equal_to_jax_oracle(shape):
    x = _inputs(shape)
    q, s, back = _port(x)
    jq, js = jref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q, np.asarray(jq))
    np.testing.assert_array_equal(s, np.asarray(js))
    np.testing.assert_array_equal(back, np.asarray(
        jref.dequantize_int8(jq, js)))
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.all(s[0, 0] == np.float32(1e-12)) and np.all(q[0, :256] == 0)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_plain_matches_jax_kernels(shape):
    """The Pallas kernels in interpret mode, as the JAX package's tests
    run them on the CPU."""
    x = _inputs(shape, seed=1)
    q, s, back = _port(x)
    jq, js = jops.quantize_int8(jnp.asarray(x), interpret=True)
    jq, js = np.asarray(jq), np.asarray(js)
    jback = np.asarray(jops.dequantize_int8(jnp.asarray(jq), jnp.asarray(js),
                                            interpret=True))
    assert np.all(np.abs(s - js) <= np.spacing(js)), "scales > 1 ulp apart"
    same = np.repeat(s == js, 256, axis=-1)
    np.testing.assert_array_equal(q[same], jq[same])
    np.testing.assert_array_equal(back[same], jback[same])
    # what the kernel computes: the scale by the reciprocal
    recip = np.maximum(np.abs(x.reshape(*s.shape, 256)).max(-1)
                       * (np.float32(1) / np.float32(127)), np.float32(1e-12))
    np.testing.assert_array_equal(js, recip)


def test_ties_round_half_to_even():
    x = np.zeros((1, 256), np.float32)
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    q, s, _ = _port(x)
    assert s[0, 0] == 1.0
    assert q[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


def test_wrappers_take_only_cuda_tensors():
    x = torch.as_tensor(_inputs((3, 512)))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.quantize_int8(x)
    q, s = tref.quantize_int8(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq.dequantize_int8(q, s)
    with pytest.raises(ValueError, match="core"):
        tops.quantize_int8(x, core="fast")
    with pytest.raises(ValueError, match="multiple of 256"):
        tref.quantize_int8(torch.zeros(2, 300))


@pytest.mark.cuda
def test_kernels_bit_equal_to_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at the largest leaf of hymba-1.5b's gradient tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(1, 32256 * 1600 // 256 * 256)]:
        x = torch.as_tensor(_inputs(shape, seed=2)).cuda()
        q, s = tq.quantize_int8(x)
        wq, ws = tref.quantize_int8(x)
        assert torch.equal(q, wq) and torch.equal(s, ws), shape
        assert torch.equal(tq.dequantize_int8(wq, ws),
                           tref.dequantize_int8(wq, ws)), shape
