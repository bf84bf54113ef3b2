"""Kernel 2, the ring-AllReduce receive-accumulate: the port's plain
version (what a CPU tensor runs) against the JAX package's Pallas kernel
in interpret mode and its jnp oracle, on the same numpy-made inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_reduce as tfr  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SHAPES = [(128, 512), (64, 384), (300, 640)]
# dtype names -> (jax dtype, torch dtype)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    """tests/test_kernels.py::_tol, the reference's own kernel tolerance."""
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(shape, acc_dtype, x_dtype, seed=5):
    """The same values, rounded to each dtype by both frameworks (both
    round float32 to bfloat16 to nearest even)."""
    rng = np.random.RandomState(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    (ja, ta), (jx, tx) = DTYPES[acc_dtype], DTYPES[x_dtype]
    return (jnp.asarray(a).astype(ja), jnp.asarray(x).astype(jx),
            torch.from_numpy(a).to(ta), torch.from_numpy(x).to(tx))


def _f32(y):
    return np.asarray(y.float().numpy() if isinstance(y, torch.Tensor)
                      else jnp.asarray(y, jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_plain_matches_jax_kernel_and_oracle(shape, dtype, scale):
    ja, jx, ta, tx = _inputs(shape, dtype, dtype)
    got = tops.fused_accumulate(ta, tx, scale=scale)
    assert got.dtype == ta.dtype and tuple(got.shape) == shape
    for want in (jops.fused_accumulate(ja, jx, scale=scale),
                 jref.fused_accumulate(ja, jx, scale=scale)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


@pytest.mark.parametrize("acc_dtype,x_dtype", [("float32", "bfloat16"),
                                               ("bfloat16", "float32")])
def test_plain_mixed_types_match_jax_oracle(acc_dtype, x_dtype):
    ja, jx, ta, tx = _inputs((300, 640), acc_dtype, x_dtype, seed=7)
    got = tops.fused_accumulate(ta, tx, scale=0.25)
    assert got.dtype == ta.dtype
    np.testing.assert_allclose(
        _f32(got), _f32(jref.fused_accumulate(ja, jx, scale=0.25)),
        **_tol("bfloat16"))


def test_plain_accumulates_in_float32():
    """256 + 1 is not a bfloat16: the sum is taken in float32 and rounded
    once, exactly as the reference does."""
    ja = jnp.full((8, 128), 256.0, jnp.bfloat16)
    jx = jnp.full((8, 128), 1.0, jnp.bfloat16)
    ta = torch.full((8, 128), 256.0, dtype=torch.bfloat16)
    tx = torch.full((8, 128), 1.0, dtype=torch.bfloat16)
    got = _f32(tops.fused_accumulate(ta, tx, scale=1.0))
    np.testing.assert_array_equal(got, _f32(jops.fused_accumulate(ja, jx)))
    np.testing.assert_array_equal(got, _f32(jref.fused_accumulate(ja, jx)))


def test_wrapper_takes_only_cuda_tensors():
    a = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfr.fused_accumulate(a, a)
    with pytest.raises(ValueError, match="core"):
        tops.fused_accumulate(a, a, core="fast")
    # the CPU path is the plain version, also when the kernel is asked for
    assert torch.equal(tops.fused_accumulate(a, a + 1, 0.5),
                       tref.fused_accumulate(a, a + 1, 0.5))


def test_build_keys_on_source_and_flags(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path(src)
    assert first.name.startswith("libk_") and first.suffix == ".so"
    assert _build.library_path(src, _build.NVCC_FLAGS + ("-G",)) != first
    src.write_text("// two\n")
    assert _build.library_path(src) != first
    assert _build.log(src) == ""  # not built: no log
    assert "--fmad=false" in _build.NVCC_FLAGS


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at the fig1 tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(8192, 512), (1, 3)]:
        for acc_dtype in DTYPES:
            for x_dtype in DTYPES:
                _, _, ta, tx = _inputs(shape, acc_dtype, x_dtype)
                ta, tx = ta.cuda(), tx.cuda()
                for scale in (1.0, 0.25):
                    got = tfr.fused_accumulate(ta, tx, scale)
                    want = tref.fused_accumulate(ta, tx, scale)
                    assert torch.equal(got, want), (shape, acc_dtype,
                                                    x_dtype, scale)
