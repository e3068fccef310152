"""Two intra-op threads for the port's heavier CPU tests.

The suite runs in six worker processes on one machine; PyTorch gives each
process as many threads as the machine has cores, and the oversubscribed
threads then slow every worker several times over. Two threads run these
tests as fast as eight when they have the machine to themselves.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
