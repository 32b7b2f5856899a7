"""Shared fixture of the PyTorch port's CPU tests: one intra-op thread.

The port issues many small operations (the VO engine thousands per
frame). With PyTorch's default of one OpenMP thread per core, several
pytest-xdist workers oversubscribe the cores and the threads spin-wait:
a 4 s engine test took 160 s beside five busy processes, and 9 s with
one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
