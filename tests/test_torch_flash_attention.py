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

The bfloat16 kernels (``csrc/flash_attention_sm90.cu``,
``csrc/flash_attention_bwd_sm90.cu``) are held to ``chip_smoke.py``'s
bfloat16 limits: one bfloat16 step of the plain value (2**-7 relative)
plus 1e-5 absolute for the output, plus 1e-5 of the largest magnitude for
each gradient. Their arithmetic is modelled here on the CPU.
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
# chip_smoke.py's limits for kernel 7 and its backward on the card
FA_F32_ATOL = 1e-5
FA_BF16_RTOL = 2.0 ** -7
FA_BWD_F32_REL = 1e-5

# (B, Sq, Skv, H, KH, D): G = H / KH in {1, 2, 5}, ragged lengths; then
# the configs' other head sizes, phi3-mini's D = 96 (G = 1) and kimi-k2's
# D = 112 (G = 8), and granite-20b's G = 48 (MQA)
SHAPES = [(2, 40, 40, 4, 4, 16), (1, 37, 37, 4, 2, 128),
          (2, 64, 64, 10, 2, 64), (1, 70, 70, 5, 1, 16),
          (1, 45, 45, 3, 3, 96), (1, 37, 37, 8, 1, 112),
          (1, 29, 29, 48, 1, 16)]


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
    # bfloat16 runs on the wgmma kernel, held to chip_smoke.py's limit;
    # float32 never does
    for shape in SHAPES + [(2, 300, 300, 25, 5, 64), (1, 90, 90, 4, 4, 128),
                           (1, 300, 150, 25, 5, 64)]:
        for window in (0, 32, 100):
            for causal in (True, False):
                q, k, v = (torch.as_tensor(a).cuda().bfloat16()
                           for a in _qkv(shape))
                n32, n90 = tfa.launches, tfa.sm90_launches
                got, lse = tfa.flash_attention(q, k, v, causal=causal,
                                               window=window, return_lse=True)
                want, wl = tref.flash_attention(q, k, v, causal=causal,
                                                window=window,
                                                return_lse=True)
                assert tfa.sm90_launches - n90 == tfa.launches - n32 == 1
                err = (got.float() - want.float()).abs()
                assert bool((err <= FA_BF16_RTOL * want.float().abs()
                             + FA_F32_ATOL).all()), (shape, window, causal)
                live = torch.isfinite(wl)
                assert torch.equal(torch.isfinite(lse), live)
                assert float((lse[live] - wl[live]).abs().max()) <= 2e-5
    n90 = tfa.sm90_launches
    tfa.flash_attention(*(torch.as_tensor(a).cuda() for a in _qkv(SHAPES[0])))
    assert tfa.sm90_launches == n90


# ------------------------------------------------------------- backward
# (shape, causal, window): G = 1, 2 and 5, ragged lengths, and rows with no
# live key (Sq > Skv under a window, causal or not); then D = 96 (G = 1,
# non-causal), D = 112 (G = 8, a window) and G = 48
BWD_CASES = [(SHAPES[0], True, 0), (SHAPES[1], True, 8),
             (SHAPES[2], True, 24), (SHAPES[3], False, 0),
             ((1, 40, 24, 4, 2, 16), True, 8),
             ((1, 50, 30, 10, 2, 16), False, 10),
             (SHAPES[4], False, 0), (SHAPES[5], True, 24),
             (SHAPES[6], True, 0)]


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


def test_plain_backward_in_float64_is_the_same_function():
    """``dtype=torch.float64`` evaluates the backward's specification with
    float64 products and sums: within the float32 tolerance of the default,
    each gradient in its input's type."""
    shape, causal, window = BWD_CASES[5]
    q, k, v, do = (torch.as_tensor(a) for a in _bwd_inputs(shape, seed=7))
    o, lse = tref.flash_attention(q, k, v, causal=causal, window=window,
                                  return_lse=True)
    got = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window, dtype=torch.float64)
    want = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                    window=window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32
        assert _rel(g.numpy(), w.numpy()) <= GRAD_REL


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
    # bfloat16 on the wgmma kernels, held to chip_smoke.py's limit, and
    # deterministic: two launches agree bit for bit
    for shape, causal, window in BWD_CASES + [
            ((2, 300, 300, 25, 5, 64), True, 256),
            ((1, 300, 150, 25, 5, 64), False, 100),
            ((1, 90, 90, 4, 4, 128), True, 0)]:
        q, k, v, do = (torch.as_tensor(a).cuda().bfloat16()
                       for a in _bwd_inputs(shape, seed=6))
        o, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        n90 = tfa.sm90_bwd_launches
        got = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=window)
        again = tfa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                        window=window)
        assert tfa.sm90_bwd_launches - n90 == 2
        want = tref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                        window=window)
        for g, g2, w in zip(got, again, want):
            assert torch.equal(g, g2), shape
            err = (g.float() - w.float()).abs()
            top = float(w.float().abs().max())
            assert bool((err <= FA_BF16_RTOL * w.float().abs()
                         + FA_BWD_F32_REL * top).all()), (shape, causal,
                                                           window)


# ------------------------------------------- the bfloat16 kernels' rounding
def _bf16(x):
    return x.to(torch.bfloat16).float()


def _second_operand(x, single):
    """P or dS as the wgmma kernels feed it to their second product: bf16
    hi + lo terms (hi = bf16(x), lo = bf16(x - hi)), or hi alone."""
    hi = _bf16(x)
    return (hi,) if single else (hi, _bf16(x - hi))


def _sm90_model(q, k, v, do, window, single):
    """The wgmma kernels' arithmetic in plain PyTorch: bfloat16 operands,
    exact products and float32 sums, float32 softmax, and P (forward), P
    and dS (backward) rounded by ``_second_operand``. The backward runs on
    the plain forward's o and lse, as the kernel runs on the forward
    kernel's. Returns (o, (dq, dk, dv)) in bfloat16."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    s, mask = tref._attn_scores(q, k, True, window)  # b, kv head, g, q, key
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(-1).permute(0, 3, 1, 2)[..., None]
    o = sum(torch.einsum("bkgqc,bckd->bqkgd", t, v.float())
            for t in _second_operand(p, single))
    o = (o / l.clamp_min(1e-30)).reshape(q.shape).bfloat16()
    o_ref, lse = tref.flash_attention(q, k, v, window=window, return_lse=True)
    lse5 = lse.reshape(B, KH, G, S, 1)
    live = mask & torch.isfinite(lse5)
    p = torch.where(live, torch.exp(s - torch.where(live, lse5, 0.0)), 0.0)
    do5 = do.reshape(B, S, KH, G, D).float()
    delta = (do5 * o_ref.reshape(B, S, KH, G, D).float()).sum(-1)
    dp = torch.einsum("bqkgd,bckd->bkgqc", do5, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    scale = 1.0 / np.sqrt(D)
    q5 = q.reshape(B, S, KH, G, D).float()
    dv = sum(torch.einsum("bkgqc,bqkgd->bckd", t, do5)
             for t in _second_operand(p, single))
    dk = sum(torch.einsum("bkgqc,bqkgd->bckd", t, q5)
             for t in _second_operand(ds, single)) * scale
    dq = sum(torch.einsum("bkgqc,bckd->bqkgd", t, k.float())
             for t in _second_operand(ds, single)) * scale
    return o, (dq.reshape(q.shape).bfloat16(), dk.bfloat16(), dv.bfloat16())


@pytest.mark.parametrize("single", [False, True])
def test_sm90_rounding_model_meets_bf16_limits(single):
    """hymba-1.5b's heads (25 over 5 KV heads of 64), B = 1, S = 512,
    window 256, normal inputs: the kernels' model against the plain
    versions within chip_smoke.py's bfloat16 limits. With P and dS split
    into bf16 hi + lo no value breaks them. Rounded once to bf16 instead,
    they break them here at 85,244 of 819,200 outputs, and at 78,807 of
    819,200 dq, 17,517 of 163,840 dk and 15,149 of 163,840 dv values; at
    B = 2, S = 1280, window 1024 (dk, dv: B = 1) at 436,212 of 4,096,000
    outputs, 197,101 of 2,048,000 dq, 33,160 of 409,600 dk and 26,200 of
    409,600 dv. So the kernels keep about 16 bits of P and dS."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.as_tensor(rng.standard_normal(s, np.float32))
                   .bfloat16() for s in ((1, 512, 25, 64), (1, 512, 5, 64),
                                         (1, 512, 5, 64), (1, 512, 25, 64)))
    o, grads = _sm90_model(q, k, v, do, 256, single)
    want_o, lse = tref.flash_attention(q, k, v, window=256, return_lse=True)
    want = tref.flash_attention_bwd(q, k, v, want_o, lse, do, window=256)
    over = [int(((o.float() - want_o.float()).abs()
                 > FA_BF16_RTOL * want_o.float().abs() + FA_F32_ATOL).sum())]
    for g, w in zip(grads, want):
        w = w.float()
        top = float(w.abs().max())
        over.append(int(((g.float() - w).abs()
                         > FA_BF16_RTOL * w.abs() + FA_BWD_F32_REL * top)
                        .sum()))
    if single:
        assert all(n > 1000 for n in over), over
    else:
        assert over == [0, 0, 0, 0], over


def test_sm90_sources_export_what_the_wrapper_loads():
    """The wrapper finds each library's entry points by the source's stem
    and passes pointers, eight ints and the stream; the kernels take no
    PyTorch header (a plain C interface, built in seconds)."""
    for src, n_ptr in ((tfa.SOURCE, 5), (tfa.BWD_SOURCE, 9),
                       (tfa.SM90_SOURCE, 5), (tfa.SM90_BWD_SOURCE, 11)):
        text = src.read_text()
        head = text[text.index(f"int {src.stem}_launch("):]
        head = head[head.index("(") + 1:head.index(")")]
        assert head.count("void*") == n_ptr + 1, src.name  # + the stream
        assert head.count("int ") == 8, src.name
        assert f"const char* {src.stem}_error_string(int code)" in text
        assert "#include <torch" not in text
    for src in (tfa.SM90_SOURCE, tfa.SM90_BWD_SOURCE):
        assert '#include "sm90.cuh"' in src.read_text()


def test_bwd_head_chunks_match_the_source():
    """The wrapper sizes the bfloat16 backward's head-chunk workspace with
    the source's own number of heads a dK/dV block."""
    import re
    text = tfa.SM90_BWD_SOURCE.read_text()
    got = re.search(r"constexpr int kHeadsABlock = (\d+);", text)
    assert got and int(got.group(1)) == tfa.BWD_HEADS_A_BLOCK


def test_build_keys_on_headers(tmp_path):
    """A source's library key covers the headers beside it, so an edit to
    csrc/sm90.cuh rebuilds both wgmma kernels."""
    from repro_torch.kernels import _build
    src = tmp_path / "k.cu"
    src.write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.library_path(src)
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path(src) != first
