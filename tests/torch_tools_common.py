"""Shared by ``tests/test_torch_tools_*.py``.

The tools' tests run a small DiT through hundreds of tiny ops (250-step
samplers). On torch's default of one intra-op thread per core, six test
workers on one box spin-wait on each other's threads and run many times
slower than alone; one thread is as fast alone and does not contend.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module, then as it was."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
