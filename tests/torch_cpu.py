"""A fixture and a helper shared by the port's tests (`tests/test_torch_*.py`);
no JAX here, so that the `cuda`-marked tests run where JAX is absent."""

import pytest
import torch

from cpcsv_tpu_torch.evaluation.weights import random_init_


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


def calibrated_backbone(net, x, seed):
    """The port's random init, then BN statistics from one train-mode pass
    over `x` (numpy, channels last) and affines drawn away from identity: a random net's features
    otherwise barely depend on the input (covariances ~1e-8 of the squared
    means), and no statistic could be compared."""
    random_init_(net, seed)
    gen = torch.Generator().manual_seed(seed)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.momentum = None  # the running statistics become the pass's
            m.weight.uniform_(0.8, 1.2, generator=gen)
            m.bias.normal_(0.0, 0.05, generator=gen)
        net.train()(torch.from_numpy(x).movedim(-1, 1))
    for m in bns:
        m.momentum = 0.1
    return net.eval()
