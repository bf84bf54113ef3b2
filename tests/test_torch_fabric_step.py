"""The port's fabric-step core against the JAX package's oracle and its
Pallas kernel (interpret mode), and the CUDA wrapper's contract.

Tolerance is the DESIGN.md §13 contract (rtol 2e-4, atol 1.0 on ~1e9
byte/s magnitudes): segment sums may be taken in another order. With at
most one contributor per segment there is nothing to reorder, and the
result must be bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import fabric_step as tfs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

FS_TOL = dict(rtol=2e-4, atol=1.0)
# (F, H, L, n_src, n_sw) — the reference's kernel-test shapes
FS_SHAPES = [(7, 3, 13, 4, 5), (130, 5, 300, 33, 17), (256, 4, 255, 8, 8),
             (1, 1, 2, 1, 2)]
SCALARS = (2e-6, 2e6, 0.6, 0.7, 0.05)  # dt, qmax, hol_factor/start, jitter


def _case(rng, F, H, L, n_src, n_sw):
    return dict(
        plinks=rng.randint(0, L + 1, size=(F, H)).astype(np.int32),
        inject=(rng.rand(F) * 1e9).astype(np.float32),
        src_id=rng.randint(0, n_src, size=F).astype(np.int32),
        host_caps=((rng.rand(F) + 0.5) * 1e9).astype(np.float32),
        q=(rng.rand(L + 1) * 1e6).astype(np.float32),
        caps_finite=((rng.rand(L + 1) + 0.1) * 1e9).astype(np.float32),
        src_sw=rng.randint(0, n_sw, size=L + 1).astype(np.int32),
        dst_sw=rng.randint(0, n_sw, size=L + 1).astype(np.int32))


def _occ(case, qmax):
    return case["q"] / np.float32(qmax)


def _jax_core(fn, case, n_src, n_sw, with_aux, scalars=SCALARS):
    dt, qmax, hf, hs, bj = scalars
    return fn(case["plinks"], case["inject"], case["src_id"],
              case["host_caps"], case["q"], _occ(case, qmax),
              case["caps_finite"], case["src_sw"], case["dst_sw"],
              jnp.float32(dt), jnp.float32(qmax), jnp.float32(hf),
              jnp.float32(hs), jnp.float32(bj), n_src=n_src, n_sw=n_sw,
              with_aux=with_aux)


def _torch_core(cases, n_src, n_sw, with_aux, scalars=None):
    """Stack per-cell cases on a leading axis; geometry rows (src_id,
    caps, switch ids) stay shared when every cell has the same ones."""
    scalars = scalars or [SCALARS] * len(cases)

    def st(k):
        return torch.from_numpy(np.stack([c[k] for c in cases]))

    def shared(k):
        same = all(np.array_equal(c[k], cases[0][k]) for c in cases)
        return torch.from_numpy(cases[0][k]) if same else st(k)

    occ = np.stack([_occ(c, s[1]) for c, s in zip(cases, scalars)])
    sc = torch.tensor(np.asarray(scalars, np.float32))
    return tref.fabric_step_core(
        st("plinks"), st("inject"), shared("src_id"), st("host_caps"),
        st("q"), torch.from_numpy(occ), shared("caps_finite"),
        shared("src_sw"), shared("dst_sw"), *sc.unbind(1), n_src=n_src,
        n_sw=n_sw, with_aux=with_aux)


def _assert_match(got, want, cell=0, exact=False, msg=""):
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
            continue
        g, w = got[k][cell].numpy(), np.asarray(want[k])
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{msg}{k}")
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{msg}{k}", **FS_TOL)


@pytest.mark.parametrize("shape", FS_SHAPES)
@pytest.mark.parametrize("with_aux", [False, True])
def test_plain_core_matches_jax(shape, with_aux):
    F, H, L, n_src, n_sw = shape
    case = _case(np.random.RandomState(sum(shape)), *shape)
    got = _torch_core([case], n_src, n_sw, with_aux)
    _assert_match(got, _jax_core(jref.fabric_step_core, case, n_src, n_sw,
                                 with_aux), msg="ref ")
    _assert_match(got, _jax_core(jops.fabric_step_core, case, n_src, n_sw,
                                 with_aux), msg="pallas ")


def test_plain_core_batched_cells_are_independent():
    """Cells of one batch with their own scalars and rows give what each
    gives alone (per-cell segments never mix)."""
    F, H, L, n_src, n_sw = 130, 5, 300, 33, 17
    rng = np.random.RandomState(5)
    cases = [_case(rng, F, H, L, n_src, n_sw) for _ in range(3)]
    scalars = [SCALARS, (4e-6, 6e6, 0.85, 0.55, 0.12),
               (1e-6, 4e6, 0.0, 0.9, 0.0)]
    got = _torch_core(cases, n_src, n_sw, True, scalars)
    for b, (case, sc) in enumerate(zip(cases, scalars)):
        want = _jax_core(jref.fabric_step_core, case, n_src, n_sw, True, sc)
        _assert_match(got, want, cell=b, msg=f"cell {b} ")


def test_plain_core_bit_exact_disjoint():
    """At most one contributor per (link, hop), per source and per switch:
    bit-identical to the reference oracle and the Pallas kernel."""
    F, H = 6, 3
    L = F * H + 4
    n_src, n_sw = F + 1, L + 2
    case = _case(np.random.RandomState(0), F, H, L, n_src, n_sw)
    case["plinks"] = np.arange(F * H, dtype=np.int32).reshape(F, H)
    case["src_id"] = np.arange(F, dtype=np.int32)
    case["src_sw"] = np.arange(1, L + 2, dtype=np.int32)
    case["dst_sw"] = np.roll(np.arange(1, L + 2, dtype=np.int32), 1)
    got = _torch_core([case], n_src, n_sw, True)
    for fn in (jref.fabric_step_core, jops.fabric_step_core):
        _assert_match(got, _jax_core(fn, case, n_src, n_sw, True),
                      exact=True)


def test_plain_core_zero_capacity_nan_matches_jax():
    """Zero-capacity links under silent flows: 0 / 0 in the
    over-subscription divide gives NaN, which the flows crossing the link
    carry on through later hops and the queue update; a padded hop adds
    nothing to the sink's slot, NaN or not. The port has NaN exactly where
    the reference oracle has them, and is bit for bit equal elsewhere (one
    contributor per segment)."""
    F, H = 6, 3
    L = F * H + 4
    n_src, n_sw = F + 1, L + 2
    case = _case(np.random.RandomState(3), F, H, L, n_src, n_sw)
    case["plinks"] = np.arange(F * H, dtype=np.int32).reshape(F, H)
    case["plinks"][1, 2] = L  # a padded last hop
    case["src_id"] = np.arange(F, dtype=np.int32)
    case["src_sw"] = np.arange(1, L + 2, dtype=np.int32)
    case["dst_sw"] = np.roll(np.arange(1, L + 2, dtype=np.int32), 1)
    case["caps_finite"][[0, 3, 6]] = 0.0  # first hops of flows 0, 1, 2
    case["inject"][:2] = 0.0  # flows 0 and 1 silent, flow 2 loaded
    got = _torch_core([case], n_src, n_sw, True)
    want = _jax_core(jref.fabric_step_core, case, n_src, n_sw, True)
    assert np.isnan(np.asarray(want["achieved"])[:2]).all()
    assert np.asarray(want["achieved"])[2] == 0.0  # loaded: r / inf
    assert np.asarray(want["arrival"])[L] == 0.0  # padded hop of a NaN
    _assert_match(got, want, exact=True)  # NaN positions equal too


def test_dispatch_cpu_goes_to_plain_version():
    F, H, L, n_src, n_sw = FS_SHAPES[0]
    case = _case(np.random.RandomState(1), F, H, L, n_src, n_sw)
    want = _torch_core([case], n_src, n_sw, False)
    args = [torch.from_numpy(case[k])[None] if k in ("plinks", "inject",
                                                     "host_caps", "q")
            else torch.from_numpy(case[k]) for k in
            ("plinks", "inject", "src_id", "host_caps", "q")]
    occ = torch.from_numpy(_occ(case, SCALARS[1]))[None]
    rows = [torch.from_numpy(case[k]) for k in ("caps_finite", "src_sw",
                                                "dst_sw")]
    sc = torch.tensor([SCALARS], dtype=torch.float32).unbind(1)
    before = tfs.launches
    for core in ("kernel", "plain"):
        got = tops.fabric_step_core(*args, occ, *rows, *sc, n_src=n_src,
                                    n_sw=n_sw, core=core)
        for k in ("inject", "achieved", "arrival", "q_new", "caps_eff"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert tfs.launches == before  # the CPU never launches the kernel
    with pytest.raises(ValueError):
        tops.fabric_step_core(*args, occ, *rows, *sc, n_src=n_src,
                              n_sw=n_sw, core="fast")


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """The CUDA wrapper raises, never falls back: on CPU tensors, and on a
    geometry whose rows do not fit in one block's shared memory."""
    F, H, L, n_src, n_sw = FS_SHAPES[0]
    case = _case(np.random.RandomState(1), F, H, L, n_src, n_sw)
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    sc = torch.tensor([SCALARS], dtype=torch.float32).unbind(1)
    args = (t("plinks")[None], t("inject")[None], t("src_id"),
            t("host_caps")[None], t("q")[None], t("q")[None],
            t("caps_finite"), t("src_sw"), t("dst_sw"), *sc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfs.fabric_step_core(*args, n_src=n_src, n_sw=n_sw)
    assert tfs.smem_bytes(3908, 255, 704, False) == 4 * (255 + 3 * 704
                                                         + 3 * 3908)
    big = tfs.smem_bytes(20000, 4096, 1026, True)
    assert big > tfs.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        tfs.check_smem(20000, 4096, 1026, True)
    tfs.check_smem(14560, 4095, 1026, False)  # 4096-node LUMI fits


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Needs an NVIDIA card (sm_90a) and nvcc; chip_smoke.py runs the same
    comparison at the characterization grid's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    for shape in FS_SHAPES:
        F, H, L, n_src, n_sw = shape
        case = _case(np.random.RandomState(sum(shape)), *shape)
        want = _torch_core([case], n_src, n_sw, True)
        t = lambda k: torch.from_numpy(case[k]).cuda()  # noqa: E731
        sc = torch.tensor([SCALARS], dtype=torch.float32).cuda().unbind(1)
        occ = torch.from_numpy(_occ(case, SCALARS[1])).cuda()[None]
        got = tfs.fabric_step_core(
            t("plinks")[None], t("inject")[None], t("src_id"),
            t("host_caps")[None], t("q")[None], occ, t("caps_finite"),
            t("src_sw"), t("dst_sw"), *sc, n_src=n_src, n_sw=n_sw,
            with_aux=True)
        for k in want:
            np.testing.assert_allclose(got[k].cpu().numpy(),
                                       want[k].numpy(), **FS_TOL)
