"""Every test here runs torch on one intra-op thread: the tiny proofs gain
nothing from more, and parallel workers would contend for the cores."""

import pytest


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
