"""The port's simulator step and batched runner against the JAX engine,
on the small leaf-spine cell of the reference's kernel tests, with
geometry, parameters and state carried across by repro_torch.convert.

Lock-step: every step starts both engines from the reference's state, so
each step is held on its own: byte and rate leaves to the DESIGN.md §13
tolerance, times to rtol 2e-4 and an atol of a thousandth of a step, and
integer and flag leaves exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import congestion as jcong  # noqa: E402
from repro.core.fabric import cc as jcc  # noqa: E402
from repro.core.fabric import simulator as jsim  # noqa: E402
from repro.core.fabric import topology as jtopo  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.fabric import simulator as tsim  # noqa: E402

FS_TOL = dict(rtol=2e-4, atol=1.0)
SECONDS_LEAVES = ("t", "idle", "last_dec", "gap", "t_done", "qdel")
INT_LEAVES = ("rc", "ph", "it", "active", "advance", "wrap", "done")


def _assert_leaf(got, want, name, dt, msg):
    """One state or aux leaf: seconds to a thousandth of the step dt (the
    delay integral qd_acc to that times dt), integers and flags exact,
    bytes and rates at §13."""
    if name in INT_LEAVES:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    elif name in SECONDS_LEAVES:
        np.testing.assert_allclose(got, want, rtol=FS_TOL["rtol"],
                                   atol=1e-3 * dt, err_msg=msg)
    elif name == "qd_acc":
        np.testing.assert_allclose(got, want, rtol=FS_TOL["rtol"],
                                   atol=1e-3 * dt * dt, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **FS_TOL)
CC_PRESETS = {"dcqcn": jcc.dcqcn, "ib": jcc.infiniband,
              "slingshot": jcc.slingshot, "ai_ecn": jcc.ai_ecn}


def _jax_cell(coll="ring_allreduce", cc=jcc.dcqcn, policy=0, scale=1.0,
              n_nodes=8):
    topo = jtopo.leaf_spine(n_nodes)
    vidx, aidx = jcong.interleaved_split(n_nodes)
    nodes = np.arange(n_nodes)
    flows = jcong.build_flowset(topo, nodes[vidx], nodes[aidx], coll,
                                "incast", (1 << 20) * scale, phased=True,
                                policy_tables=True)
    geom = jsim.make_geometry(topo, flows)
    p = jsim.make_params(cc(), dt=2e-6, bytes_per_iter=flows.bytes_per_iter,
                         host_caps=flows.host_caps,
                         env=jcong.steady().params(), policy=policy,
                         flowlet_gap_s=50e-6)
    return geom, p


def _geom_to_torch(geom):
    arrays = {k: np.asarray(getattr(geom, k)) for k in tsim.GEOMETRY_FIELDS}
    return convert.geometry_from_numpy(arrays, L=geom.L, n_sw=geom.n_sw,
                                       n_src=geom.n_src, n_jobs=geom.n_jobs,
                                       intra_node=geom.intra_node)


def _params_np(p):
    return {k: None if getattr(p, k) is None else np.asarray(getattr(p, k))
            for k in tsim.PARAM_FIELDS}


def _state_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


_jax_step = jax.jit(lambda g, p, s: jsim.step_debug(g, p, s, backend="ref"))


def _lockstep(geom, p, n_steps=30):
    tg = _geom_to_torch(geom)
    tp = convert.params_from_numpy(_params_np(p))
    dt = float(p.dt)
    state = jsim.init_state(geom, p)
    t_state0 = tsim.init_state(tg, tp)
    for k, v in convert.state_to_numpy(t_state0, cell=0).items():
        np.testing.assert_array_equal(v, np.asarray(state[k]), err_msg=k)
    for i in range(n_steps):
        new, gp, aux = _jax_step(geom, p, state)
        t_new, t_gp, t_aux = tsim.step_debug(
            tg, tp, convert.state_from_numpy(_state_np(state)))
        got = convert.state_to_numpy(t_new, cell=0)
        for k in new:
            _assert_leaf(got[k], np.asarray(new[k]), k, dt,
                         f"step {i} state {k}")
        _assert_leaf(t_gp.numpy()[0], np.asarray(gp), "goodput", dt,
                     f"step {i} goodput")
        for k in aux:
            _assert_leaf(t_aux[k][0].numpy(), np.asarray(aux[k]), k, dt,
                         f"step {i} aux {k}")
        state = new


@pytest.mark.parametrize("kind", list(CC_PRESETS))
@pytest.mark.parametrize("policy", list(range(5)))
def test_step_debug_lockstep(policy, kind):
    geom, p = _jax_cell(cc=CC_PRESETS[kind], policy=policy)
    _lockstep(geom, p)


def test_step_debug_lockstep_per_flow_kind():
    """A (F,) kind vector mixing all four CC rules inside one cell."""
    geom, p = _jax_cell(policy=3)
    kinds = np.arange(geom.n_flows, dtype=np.int32) % 4
    _lockstep(geom, dataclasses.replace(p, kind=jnp.asarray(kinds)))


def test_step_debug_lockstep_wildcard_phases():
    geom, p = _jax_cell(coll="ring_allgather", policy=4)
    assert bool(np.any(np.asarray(geom.flow_phase) < 0))
    _lockstep(geom, p)


def test_make_geometry_matches():
    """The port's own make_geometry gives the reference's arrays."""
    from repro_torch.core import congestion as tcong
    from repro_torch.core.fabric import topology as ttopo

    topo, ttopo8 = jtopo.leaf_spine(8), ttopo.leaf_spine(8)
    args = (np.arange(0, 8, 2), np.arange(1, 8, 2), "alltoall", "incast",
            1 << 20)
    geom = jsim.make_geometry(topo, jcong.build_flowset(
        topo, *args, phased=True, policy_tables=True))
    tgeom = tsim.make_geometry(ttopo8, tcong.build_flowset(
        ttopo8, *args, phased=True, policy_tables=True))
    assert tgeom.meta() == {"L": geom.L, "n_sw": geom.n_sw,
                            "n_src": geom.n_src, "n_jobs": geom.n_jobs,
                            "intra_node": geom.intra_node}
    for k in tsim.GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(tgeom, k).numpy(),
                                      np.asarray(getattr(geom, k)),
                                      err_msg=k)


def test_run_cells_freezes_finished_cells():
    """Two cells that finish at different chunks: the port's host loop
    freezes each cell as the reference's batched while_loop does."""
    geom, p0 = _jax_cell(policy=0)
    _, p1 = _jax_cell(policy=3, scale=3.0)
    params = jsim.stack_params([p0, p1])
    kw = dict(chunk=128, max_chunks=40, stride=8)
    want = jsim.run_cells(geom, params, jnp.asarray(3, jnp.int32),
                          backend="ref", **kw)
    assert len(set(np.asarray(want["chunks"]).tolist())) == 2
    tp = convert.params_from_numpy(_params_np(params), batched=True)
    got = tsim.run_cells(_geom_to_torch(geom), tp, 3, device="cpu", **kw)
    for k in ("it", "chunks"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in ("t_done", "t", "fbytes"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), err_msg=k,
                                   rtol=2e-3, atol=1e-5)
    n_valid = int(got["chunks"].max()) * (kw["chunk"] // kw["stride"])
    np.testing.assert_allclose(got["trace"][:, :n_valid],
                               np.asarray(want["trace"])[:, :n_valid],
                               rtol=2e-3, atol=1.0)


def test_unported_stages_raise():
    """The fault stage is ported: an all-``none`` table steps bit for bit
    as no table. What still raises: a run left to the default device
    without a card."""
    geom, p = _jax_cell()
    tg = _geom_to_torch(geom)
    arrays = _params_np(p)
    arrays["fault"] = np.zeros((8, 6), np.float32)
    tp = convert.params_from_numpy(arrays)
    t0 = convert.params_from_numpy(_params_np(p))
    with_table, gp = tsim.step(tg, tp, tsim.init_state(tg, tp))
    without, gp0 = tsim.step(tg, t0, tsim.init_state(tg, t0))
    assert torch.equal(gp, gp0)
    for k, v in without.items():
        assert torch.equal(with_table[k], v), k
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsim.run_cells(tg, convert.params_from_numpy(_params_np(p)), 1)
