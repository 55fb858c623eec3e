"""The fixture that runs a port test module on one torch intra-op thread.

Every ``tests/test_torch_*.py`` imports ``_one_thread`` (an autouse module
fixture), so it applies there. The port's plain versions are many small
tensor ops, which a parallel test run slows by tens of times when each op
waits for threads the other workers hold.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
