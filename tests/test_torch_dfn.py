"""The port's dynamic-filter conv1d (`cpcsv_tpu_torch/ops/dynamic_filter.py`).

On the CPU, its plain version is held against the JAX package's einsum path
and its Pallas kernel in interpret mode, at the model's shape (C=3, L=124,
K=21, pad 10) and at K=7, for odd batches. The CUDA kernel is held against
the plain version in the `cuda`-marked test, which skips without a card;
JAX is reached through a fixture, so that test runs where JAX is absent:

    python -m pytest tests/test_torch_dfn.py -m cuda
"""

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.ops import dynamic_filter
from cpcsv_tpu_torch.ops.cuda import build
from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

C, L = 3, 124
SHAPES = [(1, 21, 10), (7, 21, 10), (1, 7, 3), (7, 7, 3)]  # (B, K, pad)


def _inputs(B, K, seed, O=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, C, L)).astype(np.float32),
            rng.standard_normal((B, O, C, K)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_dfn():
    """(einsum path, Pallas kernel in interpret mode) of the JAX package."""
    pytest.importorskip("jax")
    from cpcsv_tpu.ops.dynamic_filter import dynamic_filter_conv1d
    from cpcsv_tpu.ops.pallas.dfn import dfn_pallas

    return (
        lambda img, filt, pad: dynamic_filter_conv1d(img, filt, pad, use_pallas=False),
        lambda img, filt, pad: dfn_pallas(img, filt, pad, interpret=True),
    )


@pytest.mark.parametrize("B,K,pad", SHAPES)
def test_plain_matches_jax_einsum_and_pallas(jax_dfn, B, K, pad):
    image, filters = _inputs(B, K, seed=B * 100 + K)
    ours = dynamic_filter.dynamic_filter_conv1d(
        torch.from_numpy(image), torch.from_numpy(filters), pad
    ).numpy()
    assert ours.shape == (B, 1, L + 2 * pad - K + 1)
    for ref in jax_dfn:
        # float32 on both sides; the taps are summed in different orders
        np.testing.assert_allclose(ours, np.asarray(ref(image, filters, pad)),
                                   rtol=1e-5, atol=1e-5)


def test_plain_takes_any_filter_count(jax_dfn):
    image, filters = _inputs(5, 21, seed=3, O=2)
    ours = dynamic_filter.dynamic_filter_conv1d(
        torch.from_numpy(image), torch.from_numpy(filters), 10
    ).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_dfn[0](image, filters, 10)),
                               rtol=1e-5, atol=1e-5)


def test_cpu_call_never_builds(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build the CUDA kernel")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = dfn_cuda.launches
    image, filters = (torch.from_numpy(a) for a in _inputs(2, 21, seed=4))
    assert dynamic_filter.dynamic_filter_conv1d(image, filters, 10).shape == (2, 1, L)
    # the kernel's wrapper itself refuses CPU tensors and tracked gradients
    # before it would build anything
    with pytest.raises(ValueError, match="CUDA"):
        dfn_cuda.dfn_forward(image, filters, 10)
    with pytest.raises(NotImplementedError, match="training slice"):
        dfn_cuda.dfn_forward(image.requires_grad_(), filters, 10)
    assert dfn_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for B, K, pad in SHAPES + [(90, 21, 10), (1440, 21, 10)]:
        image, filters = (torch.from_numpy(a).cuda().to(dtype) for a in _inputs(B, K, seed=B))
        before = dfn_cuda.launches
        out = dynamic_filter.dynamic_filter_conv1d(image, filters, pad)
        torch.cuda.synchronize()
        assert dfn_cuda.launches == before + 1 and out.dtype == dtype
        ref = dynamic_filter.dynamic_filter_conv1d_plain(image.float(), filters.float(), pad)
        # f32: the sum order differs; bf16: one rounding of the output
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
