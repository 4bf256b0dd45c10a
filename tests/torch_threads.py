"""A fixture for the port's heavier CPU tests: one torch thread.

These tests run beside other test processes (pytest-xdist workers), where
torch's default of one thread per core oversubscribes the machine; one
thread also fixes BLAS's summation order, so that a parity test's rounding
does not depend on the machine's core count.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
