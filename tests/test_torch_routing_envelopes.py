"""The port's 64-bit mixer and congestion envelopes against the JAX
package: bit-equal, since both are exact integer/float32 arithmetic."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import envelopes as jenv  # noqa: E402
from repro.core.fabric import routing as jrouting  # noqa: E402
from repro_torch.core import envelopes as tenv  # noqa: E402
from repro_torch.core.fabric import routing as trouting  # noqa: E402

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                np.uint64)


def _limbs():
    rng = np.random.RandomState(11)
    hi = np.concatenate([np.repeat(EDGE, len(EDGE)),
                         rng.randint(0, 2 ** 32, 500, dtype=np.uint64)])
    lo = np.concatenate([np.tile(EDGE, len(EDGE)),
                         rng.randint(0, 2 ** 32, 500, dtype=np.uint64)])
    return hi, lo


def test_splitmix64_hilo_matches_uint64_reference():
    hi, lo = _limbs()
    want = jrouting.splitmix64((hi << np.uint64(32)) | lo)
    got_hi, got_lo = trouting.splitmix64_hilo(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)))
    got = (got_hi.numpy().astype(np.uint64) << np.uint64(32)) \
        | got_lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want)
    # and the numpy limb emulation the JAX package runs in its trace
    ref_hi, ref_lo = jrouting.splitmix64_hilo(hi.astype(np.uint32),
                                              lo.astype(np.uint32))
    np.testing.assert_array_equal(got_hi.numpy(), ref_hi.astype(np.int64))
    np.testing.assert_array_equal(got_lo.numpy(), ref_lo.astype(np.int64))


def test_host_routing_tables_match():
    src = np.arange(40) % 7
    dst = (np.arange(40) * 5 + 3) % 11
    np.testing.assert_array_equal(trouting.ecmp_hash(src, dst, 3),
                                  jrouting.ecmp_hash(src, dst, 3))
    rng = np.random.RandomState(2)
    paths = [[list(rng.randint(0, 30, size=4)) for _ in range(rng.randint(
        1, 5))] for _ in range(40)]
    sd = list(zip(src.tolist(), dst.tolist()))
    for mode in ("deterministic", "ecmp", "nslb"):
        np.testing.assert_array_equal(
            trouting.assign_paths(mode, sd, paths, 30, seed=1),
            jrouting.assign_paths(mode, sd, paths, 30, seed=1), err_msg=mode)


def _profiles():
    return {
        "off": jenv.no_congestion(), "steady": jenv.steady(),
        "bursty": jenv.bursty(2e-3, 0.5e-3),
        "ramp": jenv.ramp(8e-3),
        "random": jenv.random_onoff(0.5e-3, 2e-3, seed=3),
        "multi_tenant": jenv.multi_tenant(
            (jenv.bursty(0.5e-3, 0.5e-3), 1 / 3),
            (jenv.bursty(2e-3, 2e-3), 1 / 3),
            (jenv.random_onoff(4e-3, 4e-3, seed=3), 1 / 3)),
    }


T_GRID = np.concatenate([
    np.arange(0, 40e-3, 37e-6), [1.0, 3.3, 17.0, 1e4, 1.5e4, 9.9e4, 3e5]
]).astype(np.float32)


@pytest.mark.parametrize("name", list(_profiles()))
def test_envelope_at_bit_equal(name):
    env = _profiles()[name].params()
    want_jax = np.asarray(jax.vmap(lambda t: jenv.envelope_at(
        jnp.asarray(env), t))(jnp.asarray(T_GRID)))
    want_np = jenv.envelope_np(env, T_GRID)
    envs = torch.from_numpy(np.repeat(env[None], len(T_GRID), axis=0))
    got = tenv.envelope_at(envs, torch.from_numpy(T_GRID)).numpy()
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)
    np.testing.assert_array_equal(tenv.envelope_np(env, T_GRID), want_np)
    if name != "random" and name != "multi_tenant":
        # the telegraph hash may be skipped when no row reads it
        got_fast = tenv.envelope_at(envs, torch.from_numpy(T_GRID),
                                    with_random=False).numpy()
        np.testing.assert_array_equal(got_fast, want_np)


def test_profile_tables_and_labels_match():
    for name, prof in _profiles().items():
        kw = dict(kind=prof.kind, burst_s=prof.burst_s,
                  pause_s=prof.pause_s, seed=prof.seed)
        comps = tuple((tenv.Profile(p.kind, p.burst_s, p.pause_s, p.seed), w)
                      for p, w in prof.components)
        tp = tenv.Profile(components=comps, **kw)
        np.testing.assert_array_equal(tp.params(), prof.params(),
                                      err_msg=name)
        assert tp.label() == prof.label()
    np.testing.assert_array_equal(tenv.no_fault_table(),
                                  jenv.no_fault_table())
