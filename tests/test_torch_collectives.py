"""The port's collective schedules (``repro_torch.core.collectives``) and
``compressed_psum_mean`` against the JAX package's, on the same numpy
inputs.

The JAX side runs once, in a subprocess that sees 8 host devices (jax fixes
its device count when it starts, and this process must keep seeing one);
the port side runs once, on 8 spawned CPU ranks of one gloo group
(``launch.mesh.spawn_group``). Each side returns every rank's output of
every schedule, and the tests compare them rank by rank.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import collectives as C  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.optim.compression import compressed_psum_mean  # noqa: E402

N = 8
ROOT = os.path.join(os.path.dirname(__file__), "..")


def inputs():
    """Each schedule's global input, rank r's shard at [r]."""
    rng = np.random.default_rng(0)
    return {
        "x": rng.standard_normal((N, 4, 16), np.float32),  # all-gather
        "y": rng.standard_normal((N, N, 3), np.float32),   # reduce
        "z": np.arange(N * N * 2, dtype=np.float32).reshape(N, N, 2),
        "w": rng.standard_normal((N, 5), np.float32),      # incast
        # compressed mean: rows at different scales, 1000 (not a multiple
        # of the 256-block) elements, and one all-zero block
        "c": (rng.standard_normal((N, 1000), np.float32)
              * np.float32(10.0) ** rng.integers(-3, 3, (N, 1))
              ).astype(np.float32) * (np.arange(1000) >= 256),
    }


_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [sys.argv[2], sys.argv[3]]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import collectives as C
from repro.launch.mesh import compat_make_mesh
from repro.optim.compression import compressed_psum_mean
from test_torch_collectives import inputs, N

mesh = compat_make_mesh((N,), ("x",))
inp = {k: jnp.asarray(v.astype(np.float32)) for k, v in inputs().items()}
run = lambda fn, v: np.asarray(jax.jit(
    lambda a: C.run_on_mesh(mesh, "x", fn, a, P("x"), P("x")))(v))
out = {}
x = inp["x"].reshape(N * 4, 16)
out["ring_ag"] = run(lambda v: C.ring_all_gather(v, "x", N), x)
out["bidir_ring_ag"] = run(
    lambda v: C.ring_all_gather(v, "x", N, bidirectional=True), x)
out["ring_rs"] = run(lambda v: C.ring_reduce_scatter(v[0], "x", N),
                     inp["y"])
out["ring_ar"] = run(lambda v: C.ring_all_reduce(v[0], "x", N), inp["y"])
out["a2a_linear"] = run(lambda v: C.linear_all_to_all(v[0], "x", N),
                        inp["z"])
out["a2a_pairwise"] = run(lambda v: C.pairwise_all_to_all(v[0], "x", N),
                          inp["z"])
out["incast0"] = run(lambda v: C.incast_gather(v[0], "x", N, root=0),
                     inp["w"])
out["incast3"] = run(lambda v: C.incast_gather(v[0], "x", N, root=3),
                     inp["w"])
out["compressed"] = run(lambda v: compressed_psum_mean(v[0], "x", N),
                        inp["c"])
np.savez(sys.argv[1], **{k: v.reshape((N, -1) + v.shape[1:])
                          for k, v in out.items()})
print("JAX", jax.__version__, len(jax.devices()))
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_collectives") / "out.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run(
        [sys.executable, "-c", _JAX, path, os.path.join(ROOT, "src"),
         os.path.dirname(os.path.abspath(__file__))],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "JAX" in r.stdout and r.stdout.split()[-1] == str(N)
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def port_rank(ctx, inp):
    """One rank of the port side: every schedule on this rank's shards."""
    r = ctx.rank
    t = {k: torch.as_tensor(v[r]) for k, v in inp.items()}
    out = {
        "ring_ag": C.ring_all_gather(t["x"]),
        "bidir_ring_ag": C.ring_all_gather(t["x"], bidirectional=True),
        "ring_rs": C.ring_reduce_scatter(t["y"]),
        "ring_rs_kernel2": C.ring_reduce_scatter(t["y"], add=C.fused_add),
        "ring_ar": C.ring_all_reduce(t["y"]),
        "a2a_linear": C.linear_all_to_all(t["z"]),
        "a2a_pairwise": C.pairwise_all_to_all(t["z"]),
        "incast0": C.incast_gather(t["w"], root=0),
        "incast3": C.incast_gather(t["w"], root=3),
        "compressed": compressed_psum_mean(t["c"]),
        # rank r sends to r + 2 only from even ranks: odd ones get zeros
        "ppermute_partial": C.ppermute(
            t["w"], None, [(i, (i + 2) % N) for i in range(0, N, 2)]),
        "all_mean": C.all_mean(t["w"], None),
    }
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_side():
    ranks = mesh.spawn_group(port_rank, N, backend="gloo", device="cpu",
                             args=(inputs(),))
    return {k: np.stack([r[k] for r in ranks]) for k in ranks[0]}


def test_ring_all_gather(jax_side, port_side):
    for key in ("ring_ag", "bidir_ring_ag"):
        np.testing.assert_array_equal(port_side[key], jax_side[key])
        for r in range(N):  # every rank holds the whole buffer
            np.testing.assert_array_equal(port_side[key][r], inputs()["x"])


def test_ring_reduce_scatter(jax_side, port_side):
    """Bit-equal to JAX: the same n - 1 float32 additions in the same
    order; the kernel-2 hook (its plain version here) is bit-equal to the
    default add."""
    np.testing.assert_array_equal(port_side["ring_rs"], jax_side["ring_rs"])
    np.testing.assert_array_equal(port_side["ring_rs_kernel2"],
                                  port_side["ring_rs"])
    np.testing.assert_allclose(port_side["ring_rs"],
                               inputs()["y"].sum(axis=0), atol=1e-5)


def test_ring_all_reduce(jax_side, port_side):
    np.testing.assert_array_equal(port_side["ring_ar"], jax_side["ring_ar"])
    for r in range(N):
        np.testing.assert_array_equal(port_side["ring_ar"][r],
                                      port_side["ring_rs"])


def test_all_to_all_schedules(jax_side, port_side):
    z = inputs()["z"]
    for key in ("a2a_linear", "a2a_pairwise"):
        np.testing.assert_array_equal(port_side[key], jax_side[key])
        # rank r's chunk j is rank j's chunk r
        np.testing.assert_array_equal(port_side[key],
                                      z.transpose(1, 0, 2))


def test_incast(jax_side, port_side):
    w = inputs()["w"]
    for key, root in (("incast0", 0), ("incast3", 3)):
        np.testing.assert_array_equal(port_side[key], jax_side[key])
        np.testing.assert_array_equal(port_side[key][root], w)
        others = np.delete(port_side[key], root, axis=0)
        assert not others.any()


def test_compressed_psum_mean(jax_side, port_side):
    """Within 1e-6 of the largest |mean| of JAX's (the n dequantized parts
    summed in rank order here, by XLA's reduction there); every rank gets
    the same bits; int8 error against the true mean."""
    got, want = port_side["compressed"], jax_side["compressed"]
    top = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * top
    for r in range(1, N):
        np.testing.assert_array_equal(got[r], got[0])
    true = inputs()["c"].mean(axis=0)
    assert np.abs(got[0] - true).max() <= np.abs(inputs()["c"]).max() / 127
    assert not got[0][:256].any()  # the all-zero block stays zero


def test_ppermute_without_a_source_gives_zeros(port_side):
    w = inputs()["w"]
    got = port_side["ppermute_partial"]
    for r in range(N):
        if r % 2:
            assert not got[r].any()
        else:
            np.testing.assert_array_equal(got[r], w[(r - 2) % N])


def test_all_mean_is_rank_ordered_and_equal(port_side):
    w = inputs()["w"]
    want = w[0]
    for r in range(1, N):
        want = want + w[r]
    want = want / np.float32(N)
    for r in range(N):
        np.testing.assert_array_equal(port_side["all_mean"][r], want)


def test_run_on_group_is_the_mesh_runner():
    """``run_on_group``, the twin of ``run_on_mesh``: one schedule on
    spawned ranks, each rank's output back in rank order."""
    w = inputs()["w"][:4]
    out = C.run_on_group("incast_gather", list(w), backend="gloo",
                         device="cpu", root=1)
    assert len(out) == 4
    np.testing.assert_array_equal(out[1], w)
    assert not out[0].any()


def test_transport_is_the_callers_choice():
    with pytest.raises(ValueError, match="backend"):
        mesh.rank_devices(2, "mpi", "cpu")
    with pytest.raises(ValueError, match="nccl"):
        mesh.rank_devices(2, "nccl", "cpu")
    assert mesh.rank_devices(3, "gloo", "cpu") == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            mesh.rank_devices(8, "nccl", "cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.rank_devices(8, "gloo", "cuda")


def test_a_failing_rank_raises_with_its_traceback():
    with pytest.raises(RuntimeError, match="first, rank 1:"):
        mesh.spawn_group(_fail_on_rank_one, 2, backend="gloo", device="cpu",
                         timeout_s=120)


def _fail_on_rank_one(ctx):
    if ctx.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    # rank 0 waits in a collective that rank 1 never joins
    torch.distributed.barrier()


def test_wire_bytes_model_matches_reference():
    from repro.core.collectives import wire_bytes_model as jwbm

    for kind in ("ring_all_gather", "bidir_ring_all_gather",
                 "ring_all_reduce", "linear_all_to_all",
                 "pairwise_all_to_all", "incast"):
        for n in (1, 2, 8, 16):
            assert C.wire_bytes_model(kind, n, 4096.0) == \
                jwbm(kind, n, 4096.0)
