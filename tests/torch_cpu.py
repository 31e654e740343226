"""A fixture shared by the port's CPU tests (`tests/test_torch_*.py`)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """PyTorch's CPU ops on one thread while a test module of the port runs,
    the caller's setting restored after. The modules' tensors are tiny, and
    beside other busy processes (the suite's parallel workers) torch's default
    thread pool spends far longer waiting for its threads than computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
