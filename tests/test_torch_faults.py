"""The port's link-fault engine and intra-node stage against the JAX
package: the per-link fault scale bit for bit, the event constructors'
table rows, the inertness gate, one step of the intra-node stage, the
fixed-order per-source sums, and the link_fault and intra_node grids.

``fault_scale_at`` is held to the reference's function run op by op (and
to its numpy mirror ``fault_scale_np``), in float32 throughout. Under
``jax.jit`` XLA turns the division by the slot length into a product
with its reciprocal and contracts ``1 - sev * x`` into a fused
multiply-add, so the jitted reference can sit an ulp away, or a slot
away at an exact slot boundary; the grids below hold the engine to the
jitted reference within 2%."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bench as jbench  # noqa: E402
from repro.core import congestion as jcong  # noqa: E402
from repro.core import envelopes as jenv  # noqa: E402
from repro.core import scenarios as jscen  # noqa: E402
from repro.core.fabric import simulator as jsim  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core import congestion as tcong  # noqa: E402
from repro_torch.core import envelopes as tenv  # noqa: E402
from repro_torch.core import scenarios as tscen  # noqa: E402
from repro_torch.core.fabric import simulator as tsim  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402

MiB = 2 ** 20
SLOT = np.float32(jenv.FLAP_SLOT_S)


def _tables(rng, B, kinds):
    """B tables of at most two live rows each (so at most two non-unit
    factors meet on a link), kinds drawn from ``kinds``, every group id
    (GROUP_SWITCH included) and the ``none`` kind among the rows."""
    tabs = np.zeros((B, jenv.FAULT_EVENTS, jenv.FAULT_FIELDS), np.float32)
    for b in range(B):
        slots = rng.choice(jenv.FAULT_EVENTS, rng.randint(0, 3),
                           replace=False)
        for e in slots:
            tabs[b, e] = (rng.choice(kinds), rng.uniform(0, 3e-3),
                          rng.uniform(1e-4, 5e-3), rng.uniform(0, 1),
                          rng.randint(0, 6), rng.randint(0, 1000))
    # a link down for good in the first cell: the scale's floor
    tabs[0, 0] = (jenv.FAULT_OUTAGE, 0.0, 1.0, 1.0, jenv.GROUP_EDGE_UP, 1)
    return tabs


def _times(rng, tabs):
    """Per cell: on a slot boundary of its first row, just below one, and
    (every third cell) anywhere, before the window included."""
    t = np.empty(len(tabs), np.float32)
    for b, tab in enumerate(tabs):
        t0 = tab[np.argmax(tab[:, 0] > 0), 1]
        t[b] = np.float32(t0 + rng.randint(0, 20) * SLOT)
        if b % 3 == 1:
            t[b] = np.nextafter(t[b], np.float32(-1))
        elif b % 3 == 2:
            t[b] = np.float32(rng.uniform(-1e-3, 8e-3))
    return t


@pytest.mark.parametrize("seed", range(4))
def test_fault_scale_at_bit_equal_to_reference(seed):
    rng = np.random.RandomState(seed)
    B, L1 = 24, 97
    tabs = _tables(rng, B, [1, 2, 3, 4])
    t = _times(rng, tabs)
    lg = rng.randint(0, 5, (B, L1)).astype(np.int32)
    lg[:, -1] = jenv.GROUP_NONE  # the sink
    sg = np.where(rng.rand(B, L1) < 0.2, jenv.GROUP_SWITCH,
                  0).astype(np.int32)
    got = tenv.fault_scale_at(torch.as_tensor(tabs), torch.as_tensor(lg),
                              torch.as_tensor(t), torch.as_tensor(sg))
    assert got.dtype == torch.float32 and got.shape == (B, L1)
    # only the live slots, as the simulator step evaluates them
    rows = tenv.fault_rows(torch.as_tensor(tabs))
    assert torch.equal(got, tenv.fault_scale_at(
        torch.as_tensor(tabs), torch.as_tensor(lg), torch.as_tensor(t),
        torch.as_tensor(sg), rows=rows))
    with jax.disable_jit():
        for b in range(B):
            want = np.asarray(jenv.fault_scale_at(
                jnp.asarray(tabs[b]), jnp.asarray(lg[b]), jnp.float32(t[b]),
                link_sw_group=jnp.asarray(sg[b])))
            mirror = jenv.fault_scale_np(tabs[b], lg[b], t[b], sg[b])
            np.testing.assert_array_equal(got[b].numpy().view(np.uint32),
                                          want.view(np.uint32), f"cell {b}")
            np.testing.assert_array_equal(want.view(np.uint32),
                                          mirror.view(np.uint32))
    # every kind and the floor show up
    assert set(tabs[..., 0].ravel()) >= {0, 1, 2, 3, 4}
    assert (got == jenv.FAULT_FLOOR).any() and (got == 1.0).any()


def test_fault_scale_single_channel_and_shared_groups():
    """Without ``link_sw_group`` only the per-link groups match; one
    group row shared by every cell gives each cell's own row's scale."""
    rng = np.random.RandomState(7)
    tabs = _tables(rng, 6, [1, 2, 3, 4])
    tabs[:, 0] = (jenv.FAULT_FLAP, 0.0, 1.0, 0.5, jenv.GROUP_HOT, 3)
    t = _times(rng, tabs)
    lg = rng.randint(0, 5, (1, 40)).astype(np.int32)
    got = tenv.fault_scale_at(torch.as_tensor(tabs), torch.as_tensor(lg),
                              torch.as_tensor(t))
    for b in range(len(tabs)):
        want = jenv.fault_scale_np(tabs[b], lg[0], t[b])
        np.testing.assert_array_equal(got[b].numpy(), want)


def test_inert_table_scales_by_exactly_one():
    tab = torch.as_tensor(np.stack([tenv.no_fault_table()] * 3))
    lg = torch.randint(0, 6, (1, 50), dtype=torch.int32)
    out = tenv.fault_scale_at(tab, lg, torch.tensor([0.0, 1e-3, 5.0]), lg)
    assert torch.equal(out, torch.ones(3, 50))
    assert tenv.fault_rows(tab) == []


def test_event_constructors_match_reference():
    events = [
        (lambda m: m.outage(0.5e-3, 2e-3)),
        (lambda m: m.outage(0.5e-3, 2e-3, severity=0.6,
                            link_group=m.GROUP_FABRIC, seed=4)),
        (lambda m: m.flap(0.2e-3, 20e-3, duty=0.3, seed=5)),
        (lambda m: m.degrade(0.2e-3, 1.5e-3, severity=0.7)),
        (lambda m: m.jitter(0.2e-3, 20e-3, severity=0.6,
                            link_group=m.GROUP_FABRIC, seed=9)),
        (lambda m: m.switch_outage(0.5e-3, 2e-3, severity=0.9)),
    ]
    jev = [e(jcong) for e in events]
    tev = [e(tcong) for e in events]
    for a, b in zip(tev, jev):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.label() == b.label()
    np.testing.assert_array_equal(tcong.fault_table(tev),
                                  jcong.fault_table(jev))
    for base in ("no_congestion", "steady"):
        tp = tcong.with_node_cap(tcong.with_faults(
            getattr(tcong, base)(), *tev[:3]), 0.25)
        jp = jcong.with_node_cap(jcong.with_faults(
            getattr(jcong, base)(), *jev[:3]), 0.25)
        assert tp.label() == jp.label()
        assert tp.node_cap_frac == jp.node_cap_frac == 0.25
        np.testing.assert_array_equal(tp.fault_params(), jp.fault_params())
    for name in ("GROUP_EDGE_UP", "GROUP_EDGE_DOWN", "GROUP_FABRIC",
                 "GROUP_HOT", "GROUP_SWITCH", "FAULT_FLOOR", "FLAP_SLOT_S"):
        assert getattr(tenv, name) == getattr(jenv, name), name
    with pytest.raises(ValueError, match="exceed"):
        tcong.fault_table(tev * 2)


def test_inertness_gate_bit_identical_on_the_plain_path():
    """All-``none`` table and node_cap = inf against no table, 48 steps,
    every state leaf and the goodput bit for bit (pt_fault_scenarios' gate)."""
    from benchmarks import pt_fault_scenarios

    gate = pt_fault_scenarios.inertness_gate("cpu")
    assert gate == {"table": [], "intra": []}


_jax_step_debug = jax.jit(lambda g, p, s: jsim.step_debug(g, p, s,
                                                        backend="ref"))


def test_intra_node_step_matches_reference():
    """One step of the intra-node stage from the same state: the
    injection after the stage and the NIC limit, and the achieved rates,
    within 1e-6 relative of the reference's; a binding cap lowers them."""
    jcase = jbench.build_case(jsystems.get_system("leonardo"), 16,
                              "alltoall", "", intra_node=True)
    jp = jcase.cell_params(MiB, jcong.with_node_cap(jcong.steady(), 0.25),
                           1e-6)
    assert jcase.geom.intra_node == 1
    arrays = {k: np.asarray(getattr(jcase.geom, k))
              for k in tsim.GEOMETRY_FIELDS}
    g = jcase.geom
    tg = convert.geometry_from_numpy(arrays, L=g.L, n_sw=g.n_sw,
                                     n_src=g.n_src, n_jobs=g.n_jobs,
                                     intra_node=g.intra_node)
    tp = convert.params_from_numpy(
        {k: None if getattr(jp, k) is None else np.asarray(getattr(jp, k))
         for k in tsim.PARAM_FIELDS})
    state = jsim.init_state(jcase.geom, jp)
    for _ in range(3):
        new, _, aux = _jax_step_debug(jcase.geom, jp, state)
        t_new, _, t_aux = tsim.step_debug(
            tg, tp, convert.state_from_numpy(
                {k: np.asarray(v) for k, v in state.items()}))
        for k in ("inject", "achieved"):
            np.testing.assert_allclose(t_aux[k][0].numpy(),
                                       np.asarray(aux[k]), rtol=1e-6,
                                       atol=1e-3, err_msg=k)
        state = new
    # the stage binds: the node cap is a quarter of the NIC rate and each
    # node sources 15 flows
    host = float(np.max(np.asarray(jp.host_caps)))
    per_src = tsim.source_sums(t_aux["inject"], tg.src_flows)
    assert float(per_src.max()) <= 0.25 * host * (1 + 1e-6)


def test_source_sums_keep_their_bits_under_trailing_pad_flows():
    """A source's sum is the same bits with pad flows appended on a
    source of their own (a bucket's padding) and a wider table, and
    within float32 rounding of the float64 sum."""
    rng = np.random.RandomState(0)
    for n_src, F in ((1, 1), (5, 37), (33, 500), (16, 240)):
        src = rng.randint(0, n_src, F).astype(np.int32)
        x = torch.as_tensor(rng.rand(3, F) * 1e10, dtype=torch.float32)
        table = tsim.source_table(torch.as_tensor(src), n_src)
        a = tsim.source_sums(x, table)
        pad = 3 * F + 7
        src_p = np.concatenate([src, np.full(pad, n_src, np.int32)])
        x_p = torch.cat([x, torch.zeros(3, pad)], 1)
        table_p = tsim.source_table(torch.as_tensor(src_p), n_src + 1)
        assert table_p.shape[-1] > table.shape[-1]
        b = tsim.source_sums(x_p, table_p)
        assert torch.equal(a, b[:, :n_src]) and not b[:, n_src].any()
        want = np.zeros((3, n_src))
        for s in range(n_src):
            want[:, s] = x.double().numpy()[:, src == s].sum(1)
        np.testing.assert_allclose(a.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["link_fault", "intra_node"])
def test_fault_grids_match_reference(name):
    """The family's first quick grid, 4 iterations in chunks of 64 steps:
    equal iteration counts, times within 2% of the reference's
    run_scale_grid, in its order."""
    g = tscen.get(name, True).grids[0]
    jg = jscen.get(name, True).grids[0]
    kw = dict(n_iters=4, warmup=1, chunk=64)
    want = jbench.run_scale_grid(list(jg.cells), jg.victim, jg.aggressor,
                                 jg.sizes, jg.profiles, **kw)
    got = tbench.run_scale_grid(list(g.cells), g.victim, g.aggressor,
                                g.sizes, g.profiles, device="cpu", **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.system, g.n_nodes, g.victim, g.aggressor, g.profile) == \
            (w.system, w.n_nodes, w.victim, w.aggressor, w.profile)
        assert g.n_iters == w.n_iters and not g.dnf
        for f in ("t_uncongested_s", "t_congested_s", "ratio"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=0.02, err_msg=f)


@pytest.mark.parametrize("name", ["link_fault", "intra_node"])
def test_fault_bucket_padded_cell_bit_equal_to_itself_alone(name):
    """A fault (or intra-node) cell padded into a bucket with a larger
    geometry gives every output bit for bit as it gives alone."""
    sc = tscen.get(name, False)
    grid = sc.grids[0]
    cells = (("leonardo", 8), ("lumi", 16))
    profiles = (grid.profiles[0], grid.profiles[-1])
    with_ft = tcong.needs_fault_table(profiles)
    intra = any(p.node_cap_frac > 0 for p in profiles)
    cases = [tbench.build_case(tsystems.get_system(s), n, grid.victim,
                               grid.aggressor, intra_node=intra)
             for s, n in cells]
    dims, stacked = tbench.bucket_stack([c.geom for c in cases])

    def params(case, n_flows=None):
        sub = [(float(v), p) for v in (MiB,)
               for p in [tcong.no_congestion(), *profiles]]
        dts = tbench._cell_dts(case, (MiB,), len(profiles), None,
                               case.lat())
        return tsim.stack_params([case.cell_params(
            v, p, d, n_flows, with_fault_table=with_ft)
            for (v, p), d in zip(sub, dts)])
    kw = dict(chunk=64, max_chunks=60, stride=8, device="cpu")
    out = tsim.run_cells_hetero(
        stacked, tsim.stack_params([params(c, dims.n_flows) for c in cases]),
        3, **kw)
    for k, case in enumerate(cases):
        alone = tsim.run_cells(case.geom, params(case), 3, **kw)
        F, J = case.geom.n_flows, case.geom.n_jobs
        assert F < dims.n_flows or k == 1
        for key, want in alone.items():
            got = out[key][k]
            if key == "fbytes":
                got = got[:, :F]
            elif key in ("t_done", "it"):
                got = got[:, :J]
            assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), \
                f"cell {k} {key}"
        assert alone["it"][:, 0].min() >= 3
