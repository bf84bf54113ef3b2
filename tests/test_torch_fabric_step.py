"""The port's fabric-step core against the JAX package's oracle and its
Pallas kernel (interpret mode), and the CUDA wrapper's contract.

Tolerance is the DESIGN.md §13 contract (rtol 2e-4, atol 1.0 on ~1e9
byte/s magnitudes): segment sums may be taken in another order. With at
most one contributor per segment there is nothing to reorder, and the
result must be bit-exact.

The CUDA kernel sums every segment in an order its source's header note
fixes; a numpy model of that order is held to the plain version here,
and, on a card, the kernel to the model bit for bit."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the card's machine has no JAX: only the card tests run there
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:  # pragma: no cover - needs a machine without JAX
    jnp = jops = jref = None

from repro_torch.kernels import fabric_step as tfs  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401  (fixture)

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
    geometry whose hop items no cluster encodes (the rows that do not fit
    shared memory go to the workspace instead)."""
    F, H, L, n_src, n_sw = FS_SHAPES[0]
    case = _case(np.random.RandomState(1), F, H, L, n_src, n_sw)
    t = lambda k: torch.from_numpy(case[k])  # noqa: E731
    sc = torch.tensor([SCALARS], dtype=torch.float32).unbind(1)
    args = (t("plinks")[None], t("inject")[None], t("src_id"),
            t("host_caps")[None], t("q")[None], t("q")[None],
            t("caps_finite"), t("src_sw"), t("dst_sw"), *sc)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfs.fabric_step_core(*args, n_src=n_src, n_sw=n_sw)
    # 2048 flows of 8 hops over 2**21 links: (key, index) over 32 bits on
    # every cluster
    with pytest.raises(ValueError, match="32 bits"):
        tfs.launch_config(1, 2048, 8, 1 << 21, 64, 64)
    # the rows of a 4096-node LUMI cell go to the workspace, not refused
    cfg = tfs.launch_config(1, 4095, 8, 20000, 4096, 1026, with_aux=True)
    assert cfg.workspace and cfg.smem <= tfs.SMEM_LIMIT


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


# ---- the CUDA kernel's summation order (csrc/fabric_step.cu, item 3) ----

f32 = np.float32
OUTS = ("inject", "achieved", "arrival", "q_new", "caps_eff",
        "served_stage_max")
# (label, system, n_nodes, victim, aggressor): chip_smoke.py's slice shapes
SLICES = {"nanjing_ecmp/8/alltoall": ("nanjing_ecmp", 8, "alltoall",
                                      "alltoall"),
          "leonardo/64/incast": ("leonardo", 64, "ring_allgather", "incast")}
# (F, H, L+1, n_src, n_sw) of chip_smoke.py's five slice shapes, as
# bench.build_case builds them
SLICE_DIMS = {"nanjing_ecmp/8/alltoall": (24, 4, 33, 8, 8),
              "leonardo/64/incast": (63, 8, 1264, 63, 445),
              "leonardo/256/incast": (255, 8, 3908, 255, 704),
              "lumi/256/incast": (255, 7, 3580, 255, 744),
              "cresco8/256/alltoall": (16384, 4, 897, 256, 54)}


def _add(a, b):
    return (a + b).astype(f32) if isinstance(a, np.ndarray) else f32(a + b)


def _fold(vals, op):
    """One block's part of a segment, its contributions in ascending index
    order: a left fold from 0 of up to SERIAL_MAX, else 32 strided folds
    from 0 joined by a butterfly over lane ^ 16, 8, 4, 2, 1."""
    if len(vals) <= tfs.SERIAL_MAX:
        p = f32(0)
        for v in vals:
            p = op(p, v)
        return p
    p = np.zeros(32, f32)
    for j in range(32):
        for v in vals[j::32]:
            p[j] = op(p[j], v)
    for o in (16, 8, 4, 2, 1):
        p = op(p, p[np.arange(32) ^ o])
    return f32(p[0])


def _parts(seg, rank, vals, op):
    """{segment: {part: share}}, each (segment, part) group folded in
    ascending index order."""
    out = {}
    order = np.lexsort((np.arange(len(seg)), rank, seg))
    seg, rank, vals = seg[order], rank[order], vals[order]
    cut = np.flatnonzero((np.diff(seg) != 0) | (np.diff(rank) != 0)) + 1
    for lo, hi in zip(np.r_[0, cut], np.r_[cut, len(seg)]):
        if hi > lo:
            out.setdefault(int(seg[lo]), {})[int(rank[lo])] = _fold(
                vals[lo:hi], op)
    return out


def _every_rank(parts, n_parts, op):
    """((S_0 op S_1) op ...) op S_{V-1}, a part without a share giving
    0."""
    v = parts.get(0, f32(0))
    for c in range(1, n_parts):
        v = op(v, parts.get(c, f32(0)))
    return v


def _contributors(parts, op):
    """The shares of the parts that contributed, in part order."""
    ranks = sorted(parts)
    v = parts[ranks[0]]
    for c in ranks[1:]:
        v = op(v, parts[c])
    return v


def _order_model(c, sc, n_src, n_sw, with_aux, cluster):
    """The kernel's step core for one cell in numpy float32, every segment
    summed in the kernel's order on a cluster of ``cluster`` blocks: each
    part's share (the flows [p * 2048, (p + 1) * 2048) on a cluster, all
    of them on one block) folded on its own, the shares added in part
    order."""
    dt, qmax, hf, hs, bj = (f32(x) for x in sc)
    plinks = c["plinks"]
    F, H = plinks.shape
    L1 = len(c["q"])
    sink = L1 - 1
    bs = tfs.block_shape(F, H, L1, n_src, n_sw, cluster)
    frank = np.arange(F) // (bs.nf // bs.parts)  # each flow's part
    q, occ, inject = c["q"], c["occ"], c["inject"]
    with np.errstate(all="ignore"):
        src = _parts(c["src_id"], frank, inject, _add)
        src_load = np.array([_every_rank(src.get(s, {}),
                                         cluster * bs.parts, _add)
                             for s in range(n_src)], f32)
        sat = np.minimum(np.maximum((occ - hs) / (f32(1) - hs), f32(0)),
                         f32(1))
        # switch 0's stall is pinned to 1; a switch's sums are one part,
        # its owner's, whatever the cluster
        on = c["src_sw"] != 0
        whole = np.zeros(int(on.sum()), np.int64)
        sums = [_parts(c["src_sw"][on], whole, v[on], op) for v, op in
                ((q * sat, _add), (q, _add), (sat, np.maximum))]
        stall = np.ones(n_sw, f32)
        for s in range(1, n_sw):
            hot, tot, mx = (_every_rank(x.get(s, {}), 1, op) for x, op
                            in zip(sums, (_add, _add, np.maximum)))
            stall[s] = f32(1) - hf * mx * f32(hot / np.maximum(tot, f32(1)))
        ce = c["caps_finite"] * stall[c["dst_sw"]]
        r = inject * np.minimum(c["host_caps"] / np.maximum(
            src_load[c["src_id"]], f32(1)), f32(1))
        inject_s = r.copy()
        arrival, smax = np.zeros(L1, f32), np.zeros(L1, f32)
        for h in range(H):
            lk = plinks[:, h]
            on = np.flatnonzero(lk < sink)
            for link, parts in _parts(lk[on], frank[on], r[on],
                                      _add).items():
                ld = _contributors(parts, _add)
                arrival[link] = arrival[link] + ld
                members = on[lk[on] == link]
                r[members] = r[members] / np.maximum(ld / ce[link], f32(1))
            if with_aux:
                for link, parts in _parts(lk[on], frank[on], r[on],
                                          _add).items():
                    smax[link] = np.maximum(smax[link],
                                            _contributors(parts, _add))
        q_new = np.minimum(np.maximum(
            q + (arrival * (f32(1) + bj) - ce) * dt, f32(0)), qmax)
    q_new[sink] = 0.0
    return {"inject": inject_s, "achieved": r, "arrival": arrival,
            "q_new": q_new, "caps_eff": ce,
            "served_stage_max": smax if with_aux else None}


def _grid_cells(system, n, victim, aggr, seed):
    """The cells of a fig5-style grid (32 KiB and 2 MiB, or 4 and 16 MiB on
    Nanjing, baseline and steady) with step-core operands made as
    chip_smoke.py's core_inputs makes them: each flow on one of its
    candidate paths, rates up to its NIC cap, queues up to 0.9 qmax."""
    from repro_torch.core import bench, congestion as cong
    from repro_torch.core.fabric import simulator as sim, systems
    case = bench.build_case(systems.get_system(system), n, victim, aggr)
    sizes = (4 << 20, 16 << 20) if system.startswith("nanjing") \
        else (32 << 10, 2 << 20)
    dts = bench._cell_dts(case, sizes, 1, None, case.lat())
    cells = [(float(v), pr) for v in sizes
             for pr in (cong.no_congestion(), cong.steady())]
    p = sim.stack_params([case.cell_params(v, pr, d)
                          for (v, pr), d in zip(cells, dts)])
    geom = case.geom
    rng = np.random.RandomState(seed)
    B, F = p.dt.shape[0], geom.n_flows
    choice = (rng.rand(B, F) * geom.n_paths.numpy()).astype(np.int64)
    plinks = geom.paths[torch.arange(F), torch.as_tensor(choice)].numpy()
    inject = (p.host_caps * torch.as_tensor(rng.rand(B, F),
                                            dtype=torch.float32)).numpy()
    q = torch.as_tensor(rng.rand(B, geom.L + 1), dtype=torch.float32) \
        * p.qmax_bytes[:, None] * 0.9
    q[:, -1] = 0.0
    occ = (q / p.qmax_bytes[:, None]).numpy()
    geo = {k: getattr(geom, k).numpy() for k in ("src_id", "caps_finite",
                                                 "src_sw", "dst_sw")}
    out = [dict(plinks=plinks[b].astype(np.int32), inject=inject[b],
                host_caps=p.host_caps[b].numpy(), q=q[b].numpy(),
                occ=occ[b], **geo) for b in range(B)]
    scalars = [tuple(float(x[b]) for x in (p.dt, p.qmax_bytes, p.hol_factor,
                                            p.hol_start, p.burst_jitter))
               for b in range(B)]
    return out, scalars, geom.n_src, geom.n_sw


def _random_cells(shape, B, seed):
    rng = np.random.RandomState(seed)
    cells = []
    for _ in range(B):
        c = _case(rng, *shape)
        c["occ"] = _occ(c, SCALARS[1])
        cells.append(c)
    return cells, [SCALARS] * B


def _plain_cells(cells, scalars, n_src, n_sw, with_aux):
    t = lambda k: torch.from_numpy(np.stack([c[k] for c in cells]))  # noqa
    sc = torch.tensor(np.asarray(scalars, np.float32))
    return tref.fabric_step_core(
        t("plinks"), t("inject"), t("src_id"), t("host_caps"), t("q"),
        t("occ"), t("caps_finite"), t("src_sw"), t("dst_sw"), *sc.unbind(1),
        n_src=n_src, n_sw=n_sw, with_aux=with_aux)


def _hold_model_to_plain(cells, scalars, n_src, n_sw, with_aux, cluster):
    want = _plain_cells(cells, scalars, n_src, n_sw, with_aux)
    for b, (c, sc) in enumerate(zip(cells, scalars)):
        got = _order_model(c, sc, n_src, n_sw, with_aux, cluster)
        for k in OUTS:
            if want[k] is None:
                assert got[k] is None
                continue
            w, g = want[k][b].numpy(), got[k]
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), k)
            ok = ~np.isnan(w)
            np.testing.assert_allclose(g[ok], w[ok], err_msg=f"cell {b} {k}",
                                       **FS_TOL)


@pytest.mark.parametrize("label", sorted(SLICES))
@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_matches_plain_at_slice_shapes(label, with_aux):
    """The kernel's summation order on the hot incast link (leonardo/64)
    and alltoall's shared links (nanjing), with the cluster the wrapper
    picks there, within §13 of the plain version."""
    cells, scalars, n_src, n_sw = _grid_cells(*SLICES[label], seed=100)
    F, H = cells[0]["plinks"].shape
    cfg = tfs.launch_config(len(cells), F, H, len(cells[0]["q"]), n_src,
                            n_sw, with_aux)
    _hold_model_to_plain(cells, scalars, n_src, n_sw, with_aux, cfg.cluster)


@pytest.mark.parametrize("shape", FS_SHAPES)
@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_matches_plain_random(shape, with_aux):
    cells, scalars = _random_cells(shape, 2, sum(shape))
    _hold_model_to_plain(cells, scalars, shape[3], shape[4], with_aux, 1)


@pytest.mark.parametrize("cluster", [2, 8])
@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_on_a_cluster_matches_plain(cluster, with_aux):
    """Parts of a cluster's blocks added in rank order (3000 flows: two
    blocks of FLOWS_PER_PART hold them, the rest of the cluster none),
    with segments long enough for the warp's butterfly (about 150 flows a
    link and hop)."""
    shape = (3000, 3, 20, 9, 4)
    cells, scalars = _random_cells(shape, 2, 11)
    _hold_model_to_plain(cells, scalars, shape[3], shape[4], with_aux,
                         cluster)


def _fault_cells(seed):
    """leonardo/64/incast's cells with each cell's own link capacities, as
    the engine's fault stage gives them: a tenth of the links at
    FAULT_FLOOR, a fifth degraded, the sink at 1.0."""
    from repro_torch.core.envelopes import FAULT_FLOOR
    cells, scalars, n_src, n_sw = _grid_cells(*SLICES["leonardo/64/incast"],
                                              seed=seed)
    rng = np.random.RandomState(seed)
    for c in cells:
        L1 = len(c["caps_finite"])
        scale = np.ones(L1, np.float32)
        u = rng.rand(L1 - 1)
        scale[:-1][u < 0.3] = rng.uniform(0.3, 1.0, (u < 0.3).sum())
        scale[:-1][u < 0.1] = FAULT_FLOOR
        c["caps_finite"] = (c["caps_finite"] * scale).astype(np.float32)
    assert not np.array_equal(cells[0]["caps_finite"],
                              cells[1]["caps_finite"])
    return cells, scalars, n_src, n_sw


@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_matches_plain_with_fault_scaled_caps(with_aux):
    """Per-cell capacities, some links at FAULT_FLOOR (the engine's fault
    stage): the kernel's order model within §13 of the plain version."""
    cells, scalars, n_src, n_sw = _fault_cells(300)
    _hold_model_to_plain(cells, scalars, n_src, n_sw, with_aux, 1)


def test_order_model_is_not_the_plain_order():
    """The model's butterfly is a different order from the plain
    version's: with segments longer than SERIAL_MAX some bits differ (the
    §13 tolerance is what holds them together)."""
    shape = (700, 3, 20, 9, 4)
    cells, scalars = _random_cells(shape, 1, 11)
    want = _plain_cells(cells, scalars, 9, 4, False)["arrival"][0].numpy()
    got = _order_model(cells[0], scalars[0], 9, 4, False, 1)["arrival"]
    assert not np.array_equal(got, want)
    np.testing.assert_allclose(got, want, **FS_TOL)


@pytest.mark.parametrize("label", sorted(SLICE_DIMS))
def test_launch_config_depends_on_shapes_only(label):
    """The same block and cluster for one cell or 64, with or without the
    aux observer, and a layout that fits a Hopper block."""
    F, H, L1, n_src, n_sw = SLICE_DIMS[label]
    one = tfs.launch_config(1, F, H, L1, n_src, n_sw)
    many = tfs.launch_config(64, F, H, L1, n_src, n_sw)
    aux = tfs.launch_config(64, F, H, L1, n_src, n_sw, with_aux=True)
    assert (one.threads, one.cluster, one.smem) \
        == (many.threads, many.cluster, many.smem)
    assert (aux.threads, aux.cluster) == (one.threads, one.cluster)
    assert (one.grid, many.grid) == (one.cluster, 64 * one.cluster)
    assert one.smem <= aux.smem <= tfs.SMEM_LIMIT == 232448
    assert one.threads in (tfs.SMALL_THREADS, tfs.MAX_THREADS)
    # a small cell is one block; cresco8's 16,384 flows spread over eight
    assert one.cluster == (8 if F > tfs.FLOWS_PER_PART else 1)
    assert F <= one.cluster * tfs.FLOWS_PER_PART
    bs = tfs.block_shape(F, H, L1, n_src, n_sw, one.cluster)
    assert bs.n_items < 65536 and bs.ib + bs.kb <= 31


def test_launch_config_refuses_where_check_smem_refuses():
    """What the old per-block gate refused (rows over 227 KB: 4096-node
    LUMI with aux) now runs in the wide layout, on the cluster the cell
    takes without aux, for any batch; so does 4096-node LUMI without aux
    (a cluster's blocks group every link of their switches, up to L+1
    items each, so its rows no longer fit shared memory)."""
    big = dict(F=4095, H=8, L1=20000, n_src=4096, n_sw=1026)
    plain = tfs.launch_config(1, *big.values())
    for B in (1, 64):
        cfg = tfs.launch_config(B, *big.values(), with_aux=True)
        assert cfg.grid == B * cfg.cluster and cfg.smem <= tfs.SMEM_LIMIT
        assert cfg.workspace == tfs.WIDE_ROWS[:len(cfg.workspace)]
        assert cfg.ws_bytes > 0 and cfg.cluster == plain.cluster
    cfg = tfs.launch_config(4, 4095, 8, 14560, 4095, 1026)
    assert cfg.cluster > 1 and cfg.smem <= tfs.SMEM_LIMIT
    assert cfg.workspace and cfg.ws_bytes > 0


# (F, H, L+1, n_src, n_sw) of scale_sweep's 512-node alltoall bucket: its
# four cells padded together (bench.bucket_stack)
BUCKET_512 = (65536, 8, 40861, 513, 778)


@pytest.mark.parametrize("B", [1, 64])
def test_launch_config_refuses_more_flows_than_a_cluster_holds(B):
    """Past eight parts a block of the cluster owns several: the 512-node
    alltoall bucket (65,536 flows) runs on a cluster of eight blocks of
    512 threads, four parts (8,192 flows, 65,536 hop items, 32-bit item
    words) a block, in the wide layout, with and without aux; 16,384
    flows still run a part a block. A cell of more than MAX_FLOWS = 32 x
    2048 flows raises, and so does one of more than MAX_ITEMS hop items a
    block (65,536 flows of 9 hops)."""
    assert tfs.MAX_FLOWS == 65536
    for aux in (False, True):
        cfg = tfs.launch_config(B, *BUCKET_512, with_aux=aux)
        assert (cfg.grid, cfg.threads, cfg.cluster) == (8 * B, 512, 8)
        assert cfg.workspace and cfg.ws_bytes > 0
        assert cfg.smem <= tfs.SMEM_LIMIT
        bs = tfs.block_shape(*BUCKET_512, cfg.cluster)
        assert (bs.nf, bs.parts, bs.n_items) == (8192, 4, 65536)
        assert bs.ib + bs.kb == 32
    with pytest.raises(ValueError, match="at most 65536 flows"):
        tfs.launch_config(B, 65537, *BUCKET_512[1:])
    with pytest.raises(ValueError, match="at most 65536 hop items"):
        tfs.launch_config(B, 65536, 9, *BUCKET_512[2:])
    dims = dict(H=4, L1=897, n_src=129, n_sw=54)
    assert tfs.launch_config(B, 16384, *dims.values()).cluster == 8
    assert tfs.block_shape(16384, *dims.values(), 8).parts == 1


def test_smem_layout_is_the_sources_layout():
    """The wrapper lays out the fields of the source's ``Layout`` struct,
    in its order, and the kernel takes the offsets from the launch: rows
    in ascending order, the grouping scratch and a cluster's hop tables
    starting at one offset, the total past both."""
    code = _c_functions(tfs.SOURCE.read_text())
    body = re.search(r"struct Layout \{(.*?)\};", code, re.S).group(1)
    fields = tuple(re.findall(r"\w+", body.replace("int", " ")))
    assert fields == tfs.LAYOUT_FIELDS
    words = int(re.search(r"LAYOUT_WORDS = (\d+);", code).group(1))
    assert words == len(tfs.LAYOUT_FIELDS)
    for dims, cluster in (((255, 8, 3908, 256, 704), 1),
                          ((16384, 4, 897, 129, 54), 8),
                          ((700, 3, 20, 9, 4), 2)):
        for aux in (False, True):
            off = dict(zip(tfs.LAYOUT_FIELDS,
                           tfs.smem_layout(*dims, cluster, aux)))
            kept = tfs.LAYOUT_FIELDS[:tfs.LAYOUT_FIELDS.index("tmp") + 1]
            assert [off[k] for k in kept] == sorted(off[k] for k in kept)
            assert off["tmp"] == off["part"] <= off["list"] <= off["total"]
            assert off["ord"] < off["total"]
            assert off["ws"] % 4 == 0  # the radix counts are read as int4


def test_cluster_and_part_limits_are_the_sources():
    """The source's largest cluster, part size, parts a cell, hop items a
    block and item word are the wrapper's, and its launcher refuses a
    cluster past the wrapper's largest."""
    code = _c_functions(tfs.SOURCE.read_text())

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", code).group(1)
    assert int(const("MAX_CLUSTER")) == tfs.CLUSTER_SIZES[-1] == 8
    assert 1 << int(const("PART_BITS")) == tfs.FLOWS_PER_PART
    assert const("FLOWS_PER_PART") == "1 << PART_BITS"
    assert int(const("MAX_PARTS")) == tfs.MAX_PARTS
    assert int(const("MAX_ITEMS")) == tfs.MAX_ITEMS
    assert int(const("KEY_BITS")) == tfs.KEY_BITS
    assert "cluster > MAX_CLUSTER" in code and "s.V > MAX_PARTS" in code
    assert all(c & (c - 1) == 0 for c in tfs.CLUSTER_SIZES)


def _c_functions(src):
    """The source with comments dropped."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_launch_signature_matches_argtypes():
    """The source's extern "C" launcher takes what the wrapper's ctypes
    argtypes pass, parameter by parameter."""
    import ctypes
    code = _c_functions(tfs.SOURCE.read_text())
    m = re.search(r"int fabric_step_core_launch\((.*?)\)\s*\{", code, re.S)
    params = [p.strip() for p in m.group(1).split(",")]
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
             "long long": ctypes.c_longlong,
             "int*": ctypes.POINTER(ctypes.c_int)}
    types = [kinds[re.sub(r"\s*\w+$", "", p).replace("const ", "")
                   .replace(" *", "*")] for p in params]
    assert types == tfs.ARGTYPES
    names = [re.findall(r"\w+", p)[-1] for p in params]
    assert names[-4:] == ["threads", "cluster", "layout", "stream"]


def test_kernel_sums_without_float_atomics():
    """Atomics only count, place, mark and list, on int tables: no float
    atomicAdd, and no atomic at all on a row of rates or queues."""
    code = _c_functions(tfs.SOURCE.read_text())
    calls = re.findall(r"(atomic\w+)\(([^,]+),", code)
    assert calls
    ints = ("boff", "hist", "nlong", "nlist", "touch")
    for fn, target in calls:
        assert fn in ("atomicAdd", "atomicOr"), fn
        assert any(t in target for t in ints), (fn, target)
    assert "float* " not in "".join(t for _, t in calls)


def _card_tensors(cells, scalars, n_src, n_sw):
    def t(k):
        return torch.from_numpy(np.stack([c[k] for c in cells])).cuda()
    sc = torch.tensor(np.asarray(scalars, np.float32)).cuda().unbind(1)
    return (t("plinks"), t("inject"), t("src_id"), t("host_caps"), t("q"),
            t("occ"), t("caps_finite"), t("src_sw"), t("dst_sw"), *sc), \
        dict(n_src=n_src, n_sw=n_sw)


def _bits(x):
    return x.contiguous().view(torch.int32).cpu()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")


@pytest.mark.cuda
def test_kernel_launches_bit_equal_and_batch_invariant_on_card():
    """Ten launches bit-equal; each cell alone bit-equal to its row of the
    batched launch; and the kernel bit-equal to the order model: on one
    block, on a cluster, with ten parts (20,000 flows, two parts a block
    of the cluster of eight), and on clusters whose one-pass sort leaves
    the items in the scratch the hop tables reuse (shared layout)."""
    _needs_card()
    for cells, scalars, n_src, n_sw in (
            _grid_cells(*SLICES["leonardo/64/incast"], seed=100),
            (*_random_cells((700, 3, 20, 9, 4), 3, 11), 9, 4),
            (*_random_cells((20000, 3, 40, 9, 6), 3, 23), 9, 6),
            (*_random_cells((3000, 1, 40, 9, 6), 3, 29), 9, 6),
            (*_random_cells((20000, 1, 40, 9, 6), 3, 31), 9, 6)):
        args, kw = _card_tensors(cells, scalars, n_src, n_sw)
        cfg = tfs.launch_config(len(cells), *args[0].shape[1:],
                                args[4].shape[1], n_src, n_sw, True)
        runs = [tfs.fabric_step_core(*args, with_aux=True, **kw)
                for _ in range(10)]
        for run in runs[1:]:
            for k in OUTS:
                assert torch.equal(_bits(run[k]), _bits(runs[0][k])), k
        for b, (c, sc) in enumerate(zip(cells, scalars)):
            alone = tfs.fabric_step_core(
                *[a[b:b + 1] if a.dim() > 1 or a.shape[0] == len(cells)
                  and i not in (2, 6, 7, 8) else a
                  for i, a in enumerate(args)], with_aux=True, **kw)
            model = _order_model(c, sc, n_src, n_sw, True, cfg.cluster)
            for k in OUTS:
                assert torch.equal(_bits(alone[k][0]), _bits(runs[0][k][b]))
                np.testing.assert_array_equal(runs[0][k][b].cpu().numpy(),
                                              model[k], err_msg=k)


@pytest.mark.cuda
def test_kernel_zero_capacity_nan_pattern_on_card():
    """Zero-capacity links under silent flows give NaN where, and only
    where, the plain version does; bit-exact elsewhere (one contributor a
    segment)."""
    _needs_card()
    F, H = 6, 3
    L = F * H + 4
    case = _case(np.random.RandomState(3), F, H, L, F + 1, L + 2)
    case["plinks"] = np.arange(F * H, dtype=np.int32).reshape(F, H)
    case["plinks"][1, 2] = L
    case["src_id"] = np.arange(F, dtype=np.int32)
    case["src_sw"] = np.arange(1, L + 2, dtype=np.int32)
    case["dst_sw"] = np.roll(np.arange(1, L + 2, dtype=np.int32), 1)
    case["caps_finite"][[0, 3, 6]] = 0.0
    case["inject"][:2] = 0.0
    case["occ"] = _occ(case, SCALARS[1])
    args, kw = _card_tensors([case], [SCALARS], F + 1, L + 2)
    got = tfs.fabric_step_core(*args, with_aux=True, **kw)
    want = _plain_cells([case], [SCALARS], F + 1, L + 2, True)
    assert np.isnan(want["achieved"][0, :2].numpy()).all()
    for k in OUTS:
        g, w = got[k][0].cpu().numpy(), want[k][0].numpy()
        np.testing.assert_array_equal(g, w, err_msg=k)  # NaN where w has


@pytest.mark.cuda
def test_kernel_with_fault_scaled_caps_on_card():
    """Per-cell fault-scaled capacities (some at FAULT_FLOOR) as kernel
    1's caps operand: within §13 of the plain version, bit-equal to the
    order model, ten launches bit-equal, each cell alone bit-equal to its
    row of the batch, in the shared and the wide layout."""
    _needs_card()
    cells, scalars, n_src, n_sw = _fault_cells(300)
    args, kw = _card_tensors(cells, scalars, n_src, n_sw)
    assert args[6].shape == (len(cells), len(cells[0]["caps_finite"]))
    cfg = tfs.launch_config(len(cells), *args[0].shape[1:],
                            args[4].shape[1], n_src, n_sw, True)
    want = _plain_cells(cells, scalars, n_src, n_sw, True)
    for wide in (False, True):
        runs = [tfs.fabric_step_core(*args, with_aux=True, wide=wide, **kw)
                for _ in range(10)]
        for run in runs[1:]:
            for k in OUTS:
                assert torch.equal(_bits(run[k]), _bits(runs[0][k])), k
        for b, (c, sc) in enumerate(zip(cells, scalars)):
            alone = tfs.fabric_step_core(*[a[b:b + 1] for a in args],
                                         with_aux=True, wide=wide, **kw)
            model = _order_model(c, sc, n_src, n_sw, True, cfg.cluster)
            for k in OUTS:
                assert torch.equal(_bits(alone[k][0]), _bits(runs[0][k][b]))
                np.testing.assert_array_equal(runs[0][k][b].cpu().numpy(),
                                              model[k], err_msg=k)
                np.testing.assert_allclose(runs[0][k][b].cpu().numpy(),
                                           want[k][b].numpy(), **FS_TOL)


# ---- the wide layout: rows in a global-memory workspace ----

# (F, H, L+1, n_src, n_sw) of the paper's cells no cluster's shared layout
# holds (bench.build_case, victim ring_allgather), and Fig. 8's alltoall
# bucket padded to powers of two
WIDE_DIMS = {"lumi/128/alltoall": (4096, 7, 20512, 128, 750),
             "lumi/256/alltoall": (16384, 7, 34300, 256, 754),
             "leonardo/256/alltoall": (16384, 8, 13709, 256, 704),
             "fig8 alltoall bucket, pow2": (16384, 8, 65536, 256, 1024)}


@pytest.mark.parametrize("label", sorted(WIDE_DIMS))
@pytest.mark.parametrize("with_aux", [False, True])
def test_launch_config_takes_the_wide_cells(label, with_aux):
    """The cells the shared layout refused get a launch: a cluster of at
    most 2048 flows a block whose hop items encode, shared memory within
    Hopper's 227 KB, and the rest of the rows in the workspace."""
    dims = WIDE_DIMS[label]
    cfg = tfs.launch_config(3, *dims, with_aux=with_aux)
    F = dims[0]
    assert F <= cfg.cluster * tfs.FLOWS_PER_PART
    assert cfg.grid == 3 * cfg.cluster and cfg.threads == tfs.MAX_THREADS
    assert cfg.smem <= tfs.SMEM_LIMIT and cfg.ws_bytes > 0
    assert cfg.workspace == tfs.WIDE_ROWS[:len(cfg.workspace)]
    bs = tfs.block_shape(*dims, cfg.cluster)
    assert bs.n_items < 65536 and bs.ib + bs.kb <= 31
    # the same cluster with or without aux: one summation order
    assert cfg.cluster == tfs.launch_config(1, *dims).cluster


def test_wide_dims_are_the_cases():
    """WIDE_DIMS are the shapes bench.build_case gives those cells."""
    from repro_torch.core import bench
    from repro_torch.core.fabric import systems
    for label, dims in WIDE_DIMS.items():
        if "bucket" in label:
            continue
        system, n, aggr = label.split("/")
        g = bench.build_case(systems.get_system(system), int(n),
                             "ring_allgather", aggr).geom
        F, _, H = g.paths.shape
        assert (F, H, g.L + 1, g.n_src, g.n_sw) == dims, label


@pytest.mark.parametrize("dims,cluster", [((16384, 7, 34300, 256, 754), 8),
                                          ((700, 3, 20, 9, 4), 2)])
@pytest.mark.parametrize("with_aux", [False, True])
def test_smem_layout_wide(dims, cluster, with_aux):
    """A workspace row lies past the shared total, one after another up to
    gtotal; the rows left in shared memory keep the shared layout's order
    and fit within it."""
    shared = dict(zip(tfs.LAYOUT_FIELDS,
                      tfs.smem_layout(*dims, cluster, with_aux)))
    assert shared["gtotal"] == shared["total"]
    for k in (4, len(tfs.WIDE_ROWS)):
        rows = tfs.WIDE_ROWS[:k]
        off = dict(zip(tfs.LAYOUT_FIELDS,
                       tfs.smem_layout(*dims, cluster, with_aux, rows)))
        moved = sorted(off[r] for r in rows)
        assert moved[0] == off["total"] and moved[-1] < off["gtotal"] \
            or moved[-1] == off["gtotal"]
        assert off["total"] <= shared["total"]
        left = [f for f in tfs.LAYOUT_FIELDS[:-2] if f not in rows]
        assert all(off[f] < off["total"] or off[f] == off["total"] == 0
                   or off[f] <= off["total"] for f in left)
        assert off["ws"] == 0 and "ws" not in rows and "small" not in rows


@pytest.mark.parametrize("label", ["nanjing_ecmp/8/alltoall",
                                   "leonardo/64/incast"])
def test_order_model_wide_equals_shared(label):
    """A cell both layouts take runs on the same cluster and block in
    either (the wide layout moves rows, not work), so the order model is
    one: it holds to the plain version within §13 there and on a cluster."""
    cells, scalars, n_src, n_sw = _grid_cells(*SLICES[label], seed=100)
    F, H = cells[0]["plinks"].shape
    dims = (F, H, len(cells[0]["q"]), n_src, n_sw)
    shared = tfs.launch_config(len(cells), *dims, with_aux=True)
    wide = tfs.launch_config(len(cells), *dims, with_aux=True, wide=True)
    assert (wide.cluster, wide.threads) == (shared.cluster, shared.threads)
    assert wide.workspace == tfs.WIDE_ROWS and not shared.workspace
    assert wide.smem < shared.smem
    _hold_model_to_plain(cells[:2], scalars[:2], n_src, n_sw, True,
                         wide.cluster)


def test_order_model_at_a_wide_shape_matches_plain():
    """LUMI at 128 nodes under alltoall (the wide layout on a cluster of
    two): the kernel's order within §13 of the plain version."""
    cells, scalars, n_src, n_sw = _grid_cells(
        "lumi", 128, "ring_allgather", "alltoall", seed=101)
    F, H = cells[0]["plinks"].shape
    cfg = tfs.launch_config(1, F, H, len(cells[0]["q"]), n_src, n_sw)
    assert cfg.workspace and cfg.cluster == 2
    _hold_model_to_plain(cells[3:], scalars[3:], n_src, n_sw, False,
                         cfg.cluster)


def test_switch_sums_do_not_depend_on_the_cluster():
    """A switch's sums are one fold over its links in index order on any
    cluster (a padded cell's bits must not move with its bucket's
    cluster): the order model's stall, and so caps_eff, is the same on
    one block and on eight."""
    cells, scalars = _random_cells((700, 3, 300, 9, 40), 1, 13)
    one = _order_model(cells[0], scalars[0], 9, 40, False, 1)
    eight = _order_model(cells[0], scalars[0], 9, 40, False, 8)
    np.testing.assert_array_equal(one["caps_eff"], eight["caps_eff"])


def _pad_cell(c, n_src, F_to, n_pad_links):
    """``c`` padded as bench.bucket_stack pads a geometry and its params:
    pad flows of 0 bytes (inject 0, host cap 1.0) on a source of their own
    (``n_src``) with the sink-only path, pad links on switch 0 with zero
    queues and capacity 1.0 before the sink, which moves past them."""
    F, H = c["plinks"].shape
    L = len(c["q"]) - 1
    Lp = L + n_pad_links
    plinks = np.full((F_to, H), Lp, np.int32)
    plinks[:F] = np.where(c["plinks"] == L, Lp, c["plinks"])

    def flows(name, fill):
        return np.concatenate([c[name], np.full(F_to - F, fill,
                                                c[name].dtype)])

    def links(name, fill):
        x = c[name]
        return np.concatenate([x[:L], np.full(n_pad_links, fill, x.dtype),
                               x[L:]])
    return dict(plinks=plinks, inject=flows("inject", 0),
                src_id=flows("src_id", n_src),
                host_caps=flows("host_caps", 1), q=links("q", 0),
                occ=links("occ", 0), caps_finite=links("caps_finite", 1),
                src_sw=links("src_sw", 0), dst_sw=links("dst_sw", 0))


def _padded_equals_alone(F_to, with_aux, parts):
    """A cell of 3000 flows alone (a cluster of two) and padded to F_to
    flows and 25 more links (a cluster of eight, ``parts`` parts a
    block): the order model's bits on the cell's flows and links."""
    F, H, L, n_src, n_sw = shape = (3000, 3, 40, 9, 6)
    cells, scalars = _random_cells(shape, 1, 17)
    c, sc = cells[0], scalars[0]
    n_pad = 25
    padded = _pad_cell(c, n_src, F_to, n_pad)
    alone_cfg = tfs.launch_config(1, F, H, L + 1, n_src, n_sw, with_aux)
    pad_cfg = tfs.launch_config(1, F_to, H, L + n_pad + 1,
                                n_src + 1, n_sw, with_aux)
    assert (alone_cfg.cluster, pad_cfg.cluster) == (2, 8)
    assert tfs.block_shape(F_to, H, L + n_pad + 1, n_src + 1, n_sw,
                           8).parts == parts
    alone = _order_model(c, sc, n_src, n_sw, with_aux, alone_cfg.cluster)
    got = _order_model(padded, sc, n_src + 1, n_sw, with_aux,
                       pad_cfg.cluster)
    links = np.r_[np.arange(L), L + n_pad]
    for k in OUTS:
        if alone[k] is None:
            continue
        g = got[k][:F] if k in ("inject", "achieved") else got[k][links]
        np.testing.assert_array_equal(g.view(np.uint32),
                                      alone[k].view(np.uint32), k)
    assert not got["arrival"][L:L + n_pad].any()


@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_padded_cell_equals_alone(with_aux):
    """A cell of 3000 flows alone (a cluster of two) and padded to 16,384
    flows and 25 more links (a cluster of eight): a flow is part
    i // FLOWS_PER_PART's on any cluster, so every part of the cell is
    summed in one order in both and the order model gives the same bits
    on the cell's flows and links."""
    _padded_equals_alone(8 * tfs.FLOWS_PER_PART, with_aux, 1)


@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_padded_to_65536_flows_equals_alone(with_aux):
    """The same cell padded to 65,536 flows (32 parts, four a block of
    the cluster of eight): its two parts keep their folds and their
    order, so the order model gives the bits it gives alone."""
    _padded_equals_alone(tfs.MAX_FLOWS, with_aux, 4)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("with_aux", [False, True])
def test_order_model_with_more_than_eight_parts_matches_plain(with_aux):
    """20,000 flows (ten parts: two a block of the cluster of eight, the
    last part short), segments long enough for the warp's butterfly: the
    kernel's order within §13 of the plain version."""
    shape = (20000, 3, 40, 9, 6)
    cfg = tfs.launch_config(2, *shape[:2], shape[2] + 1, *shape[3:])
    assert cfg.cluster == 8
    assert tfs.block_shape(*shape[:2], shape[2] + 1, *shape[3:],
                           8).parts == 2
    cells, scalars = _random_cells(shape, 2, 23)
    _hold_model_to_plain(cells, scalars, shape[3], shape[4], with_aux,
                         cfg.cluster)


@pytest.mark.cuda
def test_kernel_wide_layout_on_card():
    """The wide layout at LUMI's 128-node alltoall shape within §13 of the
    plain version and bit-equal to the order model, ten launches
    bit-equal; and on a cell both layouts take, the wide layout bit-equal
    to the shared one."""
    _needs_card()
    cells, scalars, n_src, n_sw = _grid_cells(
        "lumi", 128, "ring_allgather", "alltoall", seed=101)
    args, kw = _card_tensors(cells, scalars, n_src, n_sw)
    cfg = tfs.launch_config(len(cells), *args[0].shape[1:],
                            args[4].shape[1], n_src, n_sw, True)
    assert cfg.workspace
    runs = [tfs.fabric_step_core(*args, with_aux=True, **kw)
            for _ in range(10)]
    want = _plain_cells(cells, scalars, n_src, n_sw, True)
    for k in OUTS:
        for run in runs[1:]:
            assert torch.equal(_bits(run[k]), _bits(runs[0][k])), k
        np.testing.assert_allclose(runs[0][k].cpu().numpy(), want[k].numpy(),
                                   err_msg=k, **FS_TOL)
    model = _order_model(cells[0], scalars[0], n_src, n_sw, True,
                         cfg.cluster)
    for k in OUTS:
        np.testing.assert_array_equal(runs[0][k][0].cpu().numpy(), model[k],
                                      err_msg=k)
    cells, scalars, n_src, n_sw = _grid_cells(*SLICES["leonardo/64/incast"],
                                              seed=100)
    args, kw = _card_tensors(cells, scalars, n_src, n_sw)
    shared = tfs.fabric_step_core(*args, with_aux=True, **kw)
    wide = tfs.fabric_step_core(*args, with_aux=True, wide=True, **kw)
    for k in OUTS:
        assert torch.equal(_bits(shared[k]), _bits(wide[k])), k
