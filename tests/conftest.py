"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the real single device (the 512-device override
belongs to launch/dryrun.py alone). Multi-device collective tests spawn a
subprocess with their own flags (tests/test_collectives.py)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

try:  # pragma: no cover - prefer the real library when present
    import hypothesis  # noqa: F401
except ImportError:
    # Minimal deterministic stand-in so property tests still run (with
    # bounded pseudo-random examples) on images without hypothesis.
    import functools
    import random
    import types

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw  # draw(rng, example_index) -> value

    def _integers(a, b):
        return _Strategy(
            lambda rng, i: a if i == 0 else b if i == 1 else rng.randint(a, b))

    def _floats(a, b):
        import math

        def draw(rng, i):
            if i == 0:
                return a
            if i == 1:
                return b
            if a > 0 and b / a > 1e3:  # log-uniform for wide positive ranges
                return math.exp(rng.uniform(math.log(a), math.log(b)))
            return rng.uniform(a, b)

        return _Strategy(draw)

    def _sampled_from(seq):
        seq = list(seq)
        return _Strategy(lambda rng, i: seq[i % len(seq)] if i < len(seq)
                         else rng.choice(seq))

    def _given(**strats):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                rng = random.Random(1234)
                n = getattr(wrapper, "_max_examples", 20)
                for i in range(n):
                    drawn = {k: s.draw(rng, i) for k, s in strats.items()}
                    fn(*args, **kwargs, **drawn)
            # hide the wrapped signature so pytest does not treat the
            # strategy parameters as fixtures
            import inspect

            del wrapper.__wrapped__
            wrapper.__signature__ = inspect.Signature()
            wrapper._max_examples = 20
            return wrapper
        return deco

    def _settings(max_examples=20, deadline=None, **_):
        def deco(fn):
            fn._max_examples = min(int(max_examples), 20)
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.floats = _floats
    _st.sampled_from = _sampled_from
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture(scope="session")
def host_mesh():
    from repro.launch.mesh import make_host_mesh

    return make_host_mesh()


@pytest.fixture(scope="session")
def rng0():
    import jax

    return jax.random.PRNGKey(0)
