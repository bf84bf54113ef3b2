"""Kernel 6, the fused selective scan, kernel 5, the state recurrence,
and the SSM block around them: the port's plain versions (what a CPU
tensor runs) against the JAX package's Pallas kernels in interpret mode
and its jnp oracles, the port's ``ssm_apply_seq`` / ``ssm_apply_decode``
against ``repro.models.ssm``, and the selective scan's gradient
(``ops.SelectiveScanFn``: recomputed states and the reversed adjoint
recurrence through kernel 5) against ``torch.autograd.gradcheck`` and
``jax.grad`` of the reference's block, on the same numpy-made inputs.

Tolerances, relative to the largest magnitude of the compared output
(``_close``): 2e-6 for float32. The measured gap is at most 3.2e-7, the
summation order of the y contraction and of the chunked associative
scan; a deliberate fault, A scaled by 0.999, moves the scan's outputs
and the block's y and state by 7.7e-5 to 8.9e-4 relative. bfloat16 x is
rounded the same way on both sides before the float32 scan, so the
float32 limit holds. Kernel 5's plain version rounds the product and the
sum of each step apart, where XLA fuses them on the CPU: REL again.
Gradients of the
block against ``jax.grad``: 2e-5 relative to each gradient's largest
magnitude (measured at most 6.8e-7; the reference differentiates a chunked
associative scan, the port a sequential one); the adjoint shifted by one
step moves them by 0.53.

The fused backward's plain version (``ref.fused_selective_scan_bwd``,
what ``SelectiveScanFn.backward`` runs on the CPU) against ``jax.vjp``
of the reference's oracle: GRAD_REL of each gradient's largest
magnitude (measured at most 3e-7); a bfloat16 d_x within one bfloat16
step (2**-7) of each value, as both round one float32 result. Its
checkpointed form is bit-equal for every chunk length.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssm_scan as tss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

REL = 2e-6
GRAD_REL = 2e-5
# (B, T, Di, N); T = 1 and a Di that is no multiple of any block
SHAPES = [(1, 8, 64, 8), (2, 12, 96, 16), (1, 1, 50, 8), (2, 16, 37, 16)]


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"relative error {err:.3g} > {rel}"


def _scan_inputs(shape, seed=0):
    B, T, Di, N = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    dt = np.log1p(np.exp(f(B, T, Di)))  # softplus, as the model's dt
    A = -np.exp(f(Di, N))
    return dt, A, f(B, T, N), f(B, T, N), f(B, T, Di), f(B, Di, N)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_and_oracle(shape, x_dtype):
    dt, A, Bc, Cc, x, h0 = _scan_inputs(shape)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    j = [jnp.asarray(a) for a in (dt, A, Bc, Cc)]
    y, hT = tops.fused_selective_scan(
        *(torch.as_tensor(a) for a in (dt, A, Bc, Cc)), tx,
        torch.as_tensor(h0))
    assert y.dtype == hT.dtype == torch.float32
    for jy, jh in (jops.fused_selective_scan(*j, jx, jnp.asarray(h0),
                                             block_d=32),
                   jref.fused_selective_scan(*j, jx, jnp.asarray(h0))):
        _close(y.numpy(), jy)
        _close(hT.numpy(), jh)


def test_wrapper_takes_only_cuda_tensors():
    args = [torch.as_tensor(a) for a in _scan_inputs(SHAPES[0])]
    with pytest.raises(ValueError, match="CUDA tensor"):
        tss.fused_selective_scan(*args)
    with pytest.raises(ValueError, match="core"):
        tops.fused_selective_scan(*args, core="fast")
    for a, b in zip(tops.fused_selective_scan(*args),
                    tref.fused_selective_scan(*args)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- block

def _block_params(cfg, seed):
    """One SSM layer's parameters at Mamba-like scales, so activations are
    of order one and a fault in the scan shows in y (numpy, float32)."""
    rng = np.random.default_rng(seed)
    d, di, n, r, W = (cfg.d_model, cfg.resolved_d_inner, cfg.ssm_state,
                      cfg.resolved_dt_rank, cfg.conv_width)
    f = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    p = {"in_proj": f(d, 2 * di) / np.sqrt(d),
         "conv_w": f(di, W) * 0.5, "conv_b": f(di) * 0.1,
         "x_proj": f(di, r + 2 * n) / np.sqrt(di),
         "dt_proj": f(r, di) / np.sqrt(r), "dt_bias": f(di) * 0.5 - 2.0,
         "a_log": np.log(np.tile(np.arange(1, n + 1, dtype=np.float32),
                                 (di, 1))),
         "d_skip": np.ones(di, np.float32),
         "out_proj": f(di, d) / np.sqrt(di)}
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("arch", ["hymba-1.5b", "falcon-mamba-7b"])
@pytest.mark.parametrize("S", [3, 16, 48])
def test_ssm_block_matches_jax(arch, S):
    jcfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    p = _block_params(tcfg, seed=S)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, S, tcfg.d_model), np.float32)
    jy, jc = jssm.ssm_apply_seq(jp, jnp.asarray(x), jcfg)
    ty, tc = tssm.ssm_apply_seq(tp, torch.as_tensor(x), tcfg)
    _close(ty.numpy(), jy)
    _close(tc["ssm"].numpy(), jc["ssm"])
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    # one decode step from the reference's cache
    xd = rng.standard_normal((2, tcfg.d_model), np.float32)
    jd, jdc = jssm.ssm_apply_decode(jp, jnp.asarray(xd), jc, jcfg)
    cache = {k: torch.as_tensor(np.array(v)) for k, v in jc.items()}
    td, tdc = tssm.ssm_apply_decode(tp, torch.as_tensor(xd), cache, tcfg)
    _close(td.numpy(), jd)
    _close(tdc["ssm"].numpy(), jdc["ssm"])
    np.testing.assert_array_equal(tdc["conv"].numpy(),
                                  np.asarray(jdc["conv"]))


def test_ssm_block_refuses_what_the_reference_refuses():
    """S must be a multiple of min(256, S) in both packages."""
    jcfg, tcfg = get_config("hymba-1.5b").reduced(), \
        tget("hymba-1.5b").reduced()
    p = _block_params(tcfg, seed=0)
    x = np.zeros((1, 300, tcfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jssm.ssm_apply_seq({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg)
    with pytest.raises(ValueError, match="multiple of 256"):
        tssm.ssm_apply_seq({k: torch.as_tensor(v) for k, v in p.items()},
                           torch.as_tensor(x), tcfg)
    # 512 = 2 chunks of 256 passes both
    cfg = dataclasses.replace(tcfg, d_model=16, d_inner=16)
    y, _ = tssm.ssm_apply_seq(
        {k: torch.as_tensor(v) for k, v in _block_params(cfg, 1).items()},
        torch.zeros(1, 512, 16), cfg)
    assert y.shape == (1, 512, 16)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at hymba's serve shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(2, 300, 3200, 16), (1, 64, 1000, 8)]:
        for x_dtype in (torch.float32, torch.bfloat16):
            args = [torch.as_tensor(a).cuda() for a in _scan_inputs(shape)]
            args[4] = args[4].to(x_dtype)
            for got, want in zip(tss.fused_selective_scan(*args),
                                 tref.fused_selective_scan(*args)):
                _close(got.cpu().numpy(), want.cpu().numpy(), rel=1e-5)


# ---------------------------------------------------------------- kernel 5

def _state_inputs(shape, seed=0):
    B, T, Di, N = shape
    rng = np.random.default_rng(seed)
    dA = rng.uniform(0.5, 1.0, (B, T, Di, N)).astype(np.float32)
    dBx = rng.standard_normal((B, T, Di, N), np.float32)
    return dA, dBx, rng.standard_normal((B, Di, N), np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_state_scan_plain_matches_jax_kernel_and_oracle(shape):
    dA, dBx, h0 = _state_inputs(shape)
    hs, hT = tops.ssm_scan(*(torch.as_tensor(a) for a in (dA, dBx, h0)))
    assert hs.dtype == hT.dtype == torch.float32
    j = [jnp.asarray(a) for a in (dA, dBx, h0)]
    for jhs, jhT in (jops.ssm_scan(*j, block_d=32, interpret=True),
                     jref.ssm_scan(*j)):
        _close(hs.numpy(), jhs)
        _close(hT.numpy(), jhT)


@pytest.mark.parametrize("shape", SHAPES)
def test_state_scan_reverse_is_the_flipped_scan(shape):
    dA, dBx, h0 = (torch.as_tensor(a) for a in _state_inputs(shape, seed=1))
    hs, hT = tops.ssm_scan(dA, dBx, h0, reverse=True)
    fs, fT = tref.ssm_scan(dA.flip(1), dBx.flip(1), h0)
    assert torch.equal(hs, fs.flip(1)) and torch.equal(hT, fT)


def _scan_args64(shape, seed):
    dt, A, Bc, Cc, x, h0 = (torch.as_tensor(a).double()
                            for a in _scan_inputs(shape, seed))
    return [t.requires_grad_() for t in (dt, A, Bc, Cc, x, h0)]


def test_selective_scan_gradcheck_float64():
    """Both outputs' gradients (y and h_T) for every input, at a tiny size;
    the plain versions keep float64."""
    args = _scan_args64((2, 6, 3, 8), seed=3)
    assert torch.autograd.gradcheck(
        lambda *a: tops.SelectiveScanFn.apply(*a, "kernel"), args)


def test_selective_scan_gradient_is_autograd_of_plain_loop():
    """float32: the custom backward against autograd through the plain
    time loop."""
    args = [torch.as_tensor(a).requires_grad_()
            for a in _scan_inputs((2, 16, 37, 16), seed=4)]
    gy = torch.randn(2, 16, 37, generator=torch.Generator().manual_seed(0))
    gh = torch.randn(2, 37, 16, generator=torch.Generator().manual_seed(1))
    y, hT = tops.fused_selective_scan(*args)
    got = torch.autograd.grad((y, hT), args, (gy, gh))
    y, hT = tref.fused_selective_scan(*args)
    want = torch.autograd.grad((y, hT), args, (gy, gh))
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), rel=GRAD_REL)


@pytest.mark.parametrize("arch,S", [("hymba-1.5b", 48),
                                    ("falcon-mamba-7b", 512)])
def test_ssm_block_gradients_match_jax(arch, S):
    """jax.grad of the reference's block (its chunked associative scan)
    against the port's block through SelectiveScanFn, every parameter and
    the input; S = 512 is two chunks of 256."""
    jcfg, tcfg = get_config(arch).reduced(), tget(arch).reduced()
    p = _block_params(tcfg, seed=S)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, S, tcfg.d_model), np.float32)
    w = rng.standard_normal((2, S, tcfg.d_model), np.float32)

    def jloss(jp, jx):
        y, _ = jssm.ssm_apply_seq(jp, jx, jcfg)
        return jnp.sum(y * w)

    jg = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.as_tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.as_tensor(x).requires_grad_()
    y, _ = tssm.ssm_apply_seq(tp, tx, tcfg)
    (y * torch.as_tensor(w)).sum().backward()
    for k in p:
        _close(tp[k].grad.numpy(), jg[0][k], rel=GRAD_REL)
    _close(tx.grad.numpy(), jg[1], rel=GRAD_REL)


@pytest.mark.cuda
def test_state_scan_and_gradient_match_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparisons at hymba's training shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(2, 300, 3200, 16)]:
        args = [torch.as_tensor(a).cuda() for a in _state_inputs(shape)]
        for reverse in (False, True):
            for got, want in zip(tss.ssm_scan(*args, reverse=reverse),
                                 tref.ssm_scan(*args, reverse=reverse)):
                assert torch.equal(got, want), (shape, reverse)
    args = [torch.as_tensor(a).cuda().requires_grad_()
            for a in _scan_inputs((2, 64, 300, 16), seed=5)]
    y, hT = tops.fused_selective_scan(*args)
    got = torch.autograd.grad((y.sum() + hT.sum()), args)
    y, hT = tops.fused_selective_scan(*args, core="plain")
    want = torch.autograd.grad((y.sum() + hT.sum()), args)
    for g, w in zip(got, want):
        _close(g.cpu().numpy(), w.cpu().numpy(), rel=GRAD_REL)


# ------------------------------------------------------- fused backward

BWD_CASES = [(shape, None) for shape in SHAPES] + [
    ((2, 1, 24, 16), 16),   # T = 1
    ((2, 37, 24, 16), 16),  # no chunk divides T
    ((1, 40, 20, 8), 16)]
BF16_STEP = 2.0 ** -7


def _bwd_inputs(shape, seed=0):
    """The forward's operands (non-zero h0) and non-zero dy, dh_T."""
    B, T, Di, N = shape
    rng = np.random.default_rng(seed + 100)
    return (*_scan_inputs(shape, seed),
            rng.standard_normal((B, T, Di), np.float32),
            rng.standard_normal((B, Di, N), np.float32))


def _close_bf16(got, want):
    """Each value within one bfloat16 step of a float32-rounded value."""
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    scale = float(np.abs(want).max())
    bound = BF16_STEP * np.abs(want) + GRAD_REL * scale
    assert (np.abs(got - want) <= bound).all(), \
        float((np.abs(got - want) - bound).max())


@pytest.mark.parametrize("case", BWD_CASES, ids=str)
@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax_vjp(case, x_dtype):
    """Every gradient of the selective scan, the plain backward against
    jax.vjp of the reference's oracle on the same cotangents."""
    shape, chunk = case
    dt, A, Bc, Cc, x, h0, dy, dh = _bwd_inputs(shape)
    jx = jnp.asarray(x).astype(x_dtype)
    _, vjp = jax.vjp(jref.fused_selective_scan,
                     *(jnp.asarray(a) for a in (dt, A, Bc, Cc)), jx,
                     jnp.asarray(h0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tx = torch.as_tensor(x).to(getattr(torch, x_dtype))
    got = tref.fused_selective_scan_bwd(
        *(torch.as_tensor(a) for a in (dt, A, Bc, Cc)), tx,
        *(torch.as_tensor(a) for a in (h0, dy, dh)), chunk=chunk)
    for name, g, w in zip(("d_dt", "d_A", "d_B", "d_C", "d_x", "d_h0"),
                          got, want):
        assert g.dtype == (tx.dtype if name == "d_x" else torch.float32)
        w = np.asarray(w.astype(jnp.float32))
        if name == "d_x" and x_dtype == "bfloat16":
            _close_bf16(g.float().numpy(), w)
        else:
            _close(g.float().numpy(), w, rel=GRAD_REL)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_plain_backward_same_for_every_chunk(x_dtype):
    """Checkpointing changes what is held, not what is computed: chunks of
    5 and 16 steps (neither divides T = 37) give the one-chunk result."""
    args = [torch.as_tensor(a) for a in _bwd_inputs((2, 37, 24, 16), 1)]
    args[4] = args[4].to(x_dtype)
    whole = tref.fused_selective_scan_bwd(*args)
    for chunk in (5, 16):
        got = tref.fused_selective_scan_bwd(*args, chunk=chunk)
        for g, w in zip(got, whole):
            assert torch.equal(g, w), chunk


def test_plain_backward_calls_are_bit_equal():
    args = [torch.as_tensor(a) for a in _bwd_inputs((2, 12, 96, 16), 2)]
    for g, w in zip(tref.fused_selective_scan_bwd(*args),
                    tref.fused_selective_scan_bwd(*args)):
        assert torch.equal(g, w)


def test_selective_scan_backward_dispatch():
    """SelectiveScanFn.backward on the CPU is the plain backward; the
    kernel's wrapper takes only CUDA tensors."""
    args = [torch.as_tensor(a) for a in _bwd_inputs((2, 16, 37, 16), 3)]
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    y, hT = tops.fused_selective_scan(*leaves)
    got = torch.autograd.grad((y, hT), leaves, (args[6], args[7]))
    for g, w in zip(got, tref.fused_selective_scan_bwd(*args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tss.fused_selective_scan_bwd(*args)


def test_scan_sources_export_what_the_wrappers_bind():
    """Each library's entry point takes the pointers and ints its wrapper
    passes (plus the stream), with a plain C interface; the backward sums
    in a fixed order, with no atomics."""
    for src, fn, n_ptr, n_int in (
            (tss.SOURCE, "fused_selective_scan_launch", 8, 5),
            (tss.BWD_SOURCE, "ssm_scan_bwd_launch", 17, 5),
            (tss.SCAN_SOURCE, "ssm_scan_launch", 5, 5)):
        text = src.read_text()
        head = text[text.index(f"int {fn}("):]
        head = head[head.index("(") + 1:head.index(")")]
        assert head.count("void*") == n_ptr + 1, src.name  # + the stream
        assert head.count("int ") == n_int, src.name
        assert "#include <torch" not in text
    text = tss.BWD_SOURCE.read_text()
    assert "const char* ssm_scan_bwd_error_string(int code)" in text
    assert "int ssm_scan_bwd_channels_per_block(int N)" in text
    assert "int ssm_scan_bwd_chunk()" in text
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomic" not in code.lower() and "red." not in code
    for src in (tss.SOURCE, tss.BWD_SOURCE):
        assert '#include "scan_stage.cuh"' in src.read_text()


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py's
    selective_scan_bwd_vs_plain runs the same comparison at hymba's
    training shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in SHAPES + [(2, 37, 300, 16), (1, 100, 1000, 8)]:
        for x_dtype in (torch.float32, torch.bfloat16):
            args = [torch.as_tensor(a).cuda() for a in _bwd_inputs(shape)]
            args[4] = args[4].to(x_dtype)
            got = tss.fused_selective_scan_bwd(*args)
            again = tss.fused_selective_scan_bwd(*args)
            want = tref.fused_selective_scan_bwd(*args)
            for g, a, w in zip(got, again, want):
                assert torch.equal(g, a)
                if g.dtype == torch.bfloat16:
                    _close_bf16(g.float().cpu().numpy(),
                                w.float().cpu().numpy())
                else:
                    _close(g.cpu().numpy(), w.cpu().numpy(), rel=GRAD_REL)
