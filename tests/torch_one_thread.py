"""A module-scoped fixture for the port's heavier CPU tests: one intra-op
torch thread while the module runs. Under xdist every worker's torch would
otherwise start a pool as wide as the machine, and the pools spin against
each other (several times the CPU time for the same wall time).

    from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
