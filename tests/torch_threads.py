"""A fixture that runs one port test on one ATen CPU thread.

Under pytest-xdist several workers share the cores, and a test of many
small tensor operations on ATen's full thread pool then runs tens of
times slower than alone (test_torch_lm.py's
test_plain_path_matches_committed_reference: 410 s in a tier-1 run, 16 s
on one thread). Only tests named for it take the fixture; the others,
and every test whose check is bit-equality between two runs, keep the
default pool. Use::

    from torch_threads import one_thread  # noqa: F401  (the fixture)

    @pytest.mark.usefixtures("one_thread")
    def test_...():
"""
import pytest
import torch


@pytest.fixture
def one_thread():
    """One ATen thread for the test, the pool's size restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
