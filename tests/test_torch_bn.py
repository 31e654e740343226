"""The port's train-mode BatchNorm (`cpcsv_tpu_torch/ops/batchnorm.py`) and
its reduction kernels (`ops/cuda/bn.py`).

On the CPU, the kernels' plain versions are held against the JAX package's
Pallas kernels in interpret mode, and the port's train BN (output, running
statistics, dx / dscale / dbias) against `cpcsv_tpu/ops/batchnorm.py:
bn_train_core` and the flax arm (`make_batchnorm()`), for BatchNorm1d and
BatchNorm2d, an odd row count and scale != 1. The CUDA kernels are held
against the plain versions in the `cuda`-marked test, which skips without a
card; JAX is reached through fixtures, so that test runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_bn.py -m cuda
"""

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.ops import blocks
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.ops.cuda import build

# (N, C, S): a dense head, conv maps, an odd N; the step's shapes, narrowed
SHAPES = [(7, 40, 1), (6, 12, 16), (5, 9, 64), (3, 5, 1024)]


def _x(shape, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 1.5 + shift).astype(np.float32)


@pytest.fixture(scope="module")
def jax_bn():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from cpcsv_tpu.ops import batchnorm as jax_batchnorm
    from cpcsv_tpu.ops.blocks import make_batchnorm
    from cpcsv_tpu.ops.pallas import bn as pallas_bn

    return jax, jnp, jax_batchnorm, make_batchnorm, pallas_bn


def _rows(x):
    """(N, C, S) -> the JAX (M, C) view (channels last)."""
    return x.transpose(0, 2, 1).reshape(-1, x.shape[1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_reductions_match_pallas_interpret(jax_bn, shape):
    jax, jnp, _, _, pallas_bn = jax_bn
    x, dy = _x(shape, 1, shift=0.5), _x(shape, 2)
    C = shape[1]
    mean = np.random.default_rng(3).standard_normal(C).astype(np.float32)
    inv = np.random.default_rng(4).uniform(0.5, 2.0, C).astype(np.float32)
    ours = bn_cuda.bn_stats_plain(torch.from_numpy(x))
    ref = pallas_bn.bn_stats(jnp.asarray(_rows(x)), interpret=True)
    ours += bn_cuda.bn_grad_reduce_plain(*map(torch.from_numpy, (x, dy, mean, inv)))
    ref += pallas_bn.bn_grad_reduce(jnp.asarray(_rows(x)), jnp.asarray(_rows(dy)),
                                    jnp.asarray(mean), jnp.asarray(inv), interpret=True)
    for a, r in zip(ours, ref):
        # float32 sums of up to 3,072 terms in other orders
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-5, atol=1e-3)


def _port_bn(C, dim, scale, bias):
    bn = blocks.BatchNorm1d(C) if dim == 1 else blocks.BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    return bn.train()


@pytest.mark.parametrize("shape", [(7, 40), (5, 9, 4, 4), (2, 6, 8, 8)], ids=str)
def test_train_bn_matches_bn_train_core(jax_bn, shape):
    """Output, batch statistics, running update and all three gradients."""
    jax, jnp, jax_batchnorm, _, _ = jax_bn
    C = shape[1]
    rng = np.random.default_rng(5)
    x = _x(shape, 6, shift=0.3)
    w = rng.standard_normal(shape).astype(np.float32)  # loss = sum(w * y)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)

    bn = _port_bn(C, len(shape) - 1 if len(shape) == 2 else 2, scale, bias)
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(w)).sum().backward()

    x2d = x if len(shape) == 2 else x.transpose(0, 2, 3, 1).reshape(-1, C)
    w2d = w if len(shape) == 2 else w.transpose(0, 2, 3, 1).reshape(-1, C)

    def loss(x2d, scale, bias):
        y, _, _ = jax_batchnorm.bn_train_core(x2d, scale, bias, 1e-5, True)
        return jnp.sum(y * w2d)

    y_ref, mean, var = jax_batchnorm.bn_train_core(
        jnp.asarray(x2d), jnp.asarray(scale), jnp.asarray(bias), 1e-5, True)
    dx, dscale, dbias = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x2d), jnp.asarray(scale), jnp.asarray(bias))
    M = x2d.shape[0]
    to_rows = (lambda a: a) if len(shape) == 2 else (
        lambda a: a.transpose(0, 2, 3, 1).reshape(-1, C))
    # float32; the sums and the normalize run in other orders
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_rows(y.detach().numpy()), np.asarray(y_ref), **tol)
    np.testing.assert_allclose(to_rows(xt.grad.numpy()), np.asarray(dx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dscale), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dbias), **tol)
    # running update: momentum 0.1 from (0, 1), torch's unbiased variance
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * np.asarray(mean), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * np.asarray(var) * M / (M - 1), **tol)


@pytest.mark.parametrize("dim", [1, 2])
def test_train_bn_matches_flax_arm(jax_bn, dim):
    """Two forwards in a row against `make_batchnorm()` with
    mutable=["batch_stats"]: the running statistics thread through calls,
    and the gradients match the flax arm's autodiff."""
    jax, jnp, _, make_batchnorm, _ = jax_bn
    shape = (9, 24) if dim == 1 else (3, 8, 5, 5)
    C = shape[1]
    rng = np.random.default_rng(7 + dim)
    xs = [_x(shape, 8 + dim + i, shift=0.2) for i in range(2)]
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)
    nhwc = (lambda a: a) if dim == 1 else (lambda a: a.transpose(0, 2, 3, 1))

    flax_bn = make_batchnorm()
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(nhwc(xs[0])),
                             use_running_average=False)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = variables["batch_stats"]
    bn = _port_bn(C, dim, scale, bias)
    for x in xs:
        def f(params, x):
            y, mut = flax_bn.apply({"params": params, "batch_stats": stats}, x,
                                   use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(jnp.sin(y) * y), (y, mut)

        (_, (y_ref, mut)), (g_p, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(nhwc(x)))
        stats = mut["batch_stats"]
        bn.weight.grad = bn.bias.grad = None
        xt = torch.from_numpy(x).requires_grad_()
        y = bn(xt)
        (torch.sin(y) * y).sum().backward()
        tol = dict(rtol=1e-4, atol=1e-4)  # float32, other summation orders
        np.testing.assert_allclose(nhwc(y.detach().numpy()), np.asarray(y_ref), **tol)
        np.testing.assert_allclose(nhwc(xt.grad.numpy()), np.asarray(g_x), **tol)
        np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(g_p["scale"]), **tol)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(g_p["bias"]), **tol)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), **tol)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), **tol)


def test_chunks():
    assert bn_cuda.chunks(90, 1) == 1  # dense heads: one pass
    assert bn_cuda.chunks(90, 16) == 1 and bn_cuda.chunks(90, 64) == 1
    assert bn_cuda.chunks(90, 4096) == 45  # the largest maps: two rows a block
    assert bn_cuda.chunks(7, 4096) == 3
    assert bn_cuda.chunks(1, 1 << 20) == 1  # never more chunks than rows


def test_cpu_call_never_builds(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build the CUDA kernels")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = dict(bn_cuda.launches)
    bn = blocks.BatchNorm2d(4).train()
    bn(torch.randn(3, 4, 2, 2, requires_grad=True)).sum().backward()
    x = torch.randn(2, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bn_cuda.bn_stats(x)
    with pytest.raises(ValueError, match="CUDA"):
        bn_cuda.bn_grad_reduce(x, x, torch.zeros(4), torch.ones(4))
    assert bn_cuda.launches == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the step's shapes at full width (final.yml), and odd ones
    shapes = [(90, 32768, 1), (18, 992, 16), (89, 992, 16), (90, 248, 256), (90, 1024, 64),
              (90, 128, 4096), (7, 128, 4096), (7, 37, 5), (1, 5, 1)]
    for N, C, S in shapes:
        gen = torch.Generator(device="cuda").manual_seed(N * C + S)
        x = torch.randn(N, C, S, generator=gen, device="cuda") + 0.5
        dy = torch.randn(N, C, S, generator=gen, device="cuda")
        mean = torch.randn(C, generator=gen, device="cuda")
        inv = torch.rand(C, generator=gen, device="cuda") + 0.5
        before = dict(bn_cuda.launches)
        got = bn_cuda.bn_stats(x) + bn_cuda.bn_grad_reduce(x, dy, mean, inv)
        again = bn_cuda.bn_stats(x) + bn_cuda.bn_grad_reduce(x, dy, mean, inv)
        torch.cuda.synchronize()
        assert bn_cuda.launches["bn_stats"] == before["bn_stats"] + 2
        assert bn_cuda.launches["bn_grad_reduce"] == before["bn_grad_reduce"] + 2
        ref = bn_cuda.bn_stats_plain(x.double()) + bn_cuda.bn_grad_reduce_plain(
            x.double(), dy.double(), mean.double(), inv.double())
        for a, b, r in zip(got, again, ref):
            assert torch.equal(a, b), "two launches on the same input differ"
            # float32 sums of up to 368,640 terms against a float64 reference
            torch.testing.assert_close(a.double(), r, rtol=1e-4, atol=1e-3)
