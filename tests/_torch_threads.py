"""A fixture for the port's CPU tests: one torch thread per test process.

The suite runs several test processes side by side (pytest-xdist), and
each would start a torch thread pool as wide as the machine.  The port's
CPU tests run many small ops, for which that oversubscription costs many
times the work itself; one thread per process keeps the cores busy with
work instead.  The results do not depend on it: the colour math is
integer.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
