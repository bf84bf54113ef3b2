"""Host-side case construction in the port against the JAX package: the
same allocation, flow program, pruned geometry, routing tables, per-flow
bytes and NIC caps, routing policy and dt, array for array."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bench as jbench  # noqa: E402
from repro.core.fabric import systems as jsystems  # noqa: E402
from repro_torch.core import bench as tbench  # noqa: E402
from repro_torch.core.fabric import simulator as tsim  # noqa: E402
from repro_torch.core.fabric import systems as tsystems  # noqa: E402

CASES = [("nanjing_nslb", 8, "alltoall", "alltoall"),
         ("nanjing_ecmp", 8, "alltoall", "alltoall"),
         ("leonardo", 64, "ring_allgather", "incast"),
         ("lumi", 16, "ring_allgather", "alltoall"),
         ("cresco8", 16, "ring_allgather", "incast"),
         # scale_sweep's 512-node alltoall cells: 65,536 flows
         ("cresco8", 512, "ring_allgather", "alltoall"),
         ("haicgu_ib", 512, "ring_allgather", "alltoall")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_build_case_matches(case):
    name, n, victim, aggr = case
    jc = jbench.build_case(jsystems.get_system(name), n, victim, aggr)
    tc = tbench.build_case(tsystems.get_system(name), n, victim, aggr)
    np.testing.assert_array_equal(
        tbench.allocate(tsystems.get_system(name), n),
        jbench.allocate(jsystems.get_system(name), n))
    assert tc.geom.meta() == {"L": jc.geom.L, "n_sw": jc.geom.n_sw,
                              "n_src": jc.geom.n_src,
                              "n_jobs": jc.geom.n_jobs,
                              "intra_node": jc.geom.intra_node}
    for k in tsim.GEOMETRY_FIELDS:
        np.testing.assert_array_equal(getattr(tc.geom, k).numpy(),
                                      np.asarray(getattr(jc.geom, k)),
                                      err_msg=k)
    for k in ("unit_bytes", "host_caps", "is_victim", "sweep_mask"):
        np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k),
                                      err_msg=k)
    assert (tc.policy, tc.n_victims, tc.max_phases, tc.job_names,
            tc.lat()) == (jc.policy, jc.n_victims, jc.max_phases,
                          jc.job_names, jc.lat())
    for v in (512, 32 * 1024, 4 << 20, 16 << 20):
        assert tbench.choose_dt(tc.topo, tc.n_victims, v, tc.lat(),
                                tc.max_phases) == jbench.choose_dt(
            jc.topo, jc.n_victims, v, jc.lat(), jc.max_phases)


def test_cell_params_match():
    from repro.core import congestion as jcong
    from repro_torch.core import congestion as tcong

    jc = jbench.build_case(jsystems.get_system("leonardo"), 64,
                           "ring_allgather", "incast")
    tc = tbench.build_case(tsystems.get_system("leonardo"), 64,
                           "ring_allgather", "incast")
    for jp, tp in ((jcong.steady(), tcong.steady()),
                   (jcong.no_congestion(), tcong.no_congestion())):
        want = jc.cell_params(2 << 20, jp, 1e-6)
        got = tc.cell_params(2 << 20, tp, 1e-6)
        for k in tsim.PARAM_FIELDS:
            if getattr(want, k) is None:
                assert getattr(got, k) is None, k
                continue
            np.testing.assert_array_equal(getattr(got, k).numpy(),
                                          np.asarray(getattr(want, k)),
                                          err_msg=k)


@pytest.mark.parametrize("kind", ["ring_allgather", "alltoall",
                                  "ring_allreduce", "incast"])
def test_collective_flows_match_reference(kind):
    from repro.core import congestion as jcong
    from repro_torch.core import congestion as tcong

    for nodes in ([0, 2, 4, 6], [3, 1, 7, 5, 9, 11, 13, 15], [4, 9]):
        got = tcong.collective_flows(nodes, kind, 3.0 * (1 << 20))
        assert got == jcong.collective_flows(nodes, kind, 3.0 * (1 << 20))
        assert got


@pytest.mark.parametrize("family", ["single_switch", "leaf_spine",
                                    "fat_tree", "dragonfly",
                                    "dragonfly_plus"])
def test_make_family_matches_reference(family):
    from repro.core.fabric import topology as jtopo
    from repro_torch.core.fabric import topology as ttopo

    assert sorted(ttopo.FAMILIES) == sorted(jtopo.FAMILIES)
    for n in (8, 32):
        got, want = ttopo.make_family(family, n), \
            jtopo.make_family(family, n)
        assert (got.name, got.n_nodes, got.link_names, got.meta) \
            == (want.name, want.n_nodes, want.link_names, want.meta)
        np.testing.assert_array_equal(got.caps, want.caps)
        np.testing.assert_array_equal(got.link_src_switch,
                                      want.link_src_switch)
        for src, dst in ((0, n - 1), (1, n // 2), (n - 1, 0), (3, 3)):
            assert got.paths(src, dst) == want.paths(src, dst)
    with pytest.raises(KeyError):
        ttopo.make_family("hypercube", 8)
