"""The thread pin every port parity file shares: the tier-1 command runs
the files in parallel xdist workers on shared cores, and a worker whose
torch spins a full intra-op pool slows every other worker.  A file takes
it with ``from _torch_threads import one_thread  # noqa: F401``."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
