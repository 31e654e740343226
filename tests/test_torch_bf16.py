"""The port's modules at COMPUTE_DTYPE bfloat16 against the JAX package's.

Each takes the same numpy inputs and weights as its JAX counterpart at
`dtype=jnp.bfloat16` (parameters float32 on both sides):
  * the BN reductions' plain versions on bfloat16 input against the Pallas
    kernels in interpret mode (`cpcsv_tpu/ops/pallas/bn.py`), and
    `batch_norm_train` forward and backward against `bn_train_core`
    (`cpcsv_tpu/ops/batchnorm.py`) with its output cast to bfloat16, as
    `PallasBatchNorm` casts it;
  * the DFN's plain version, forward and backward, against the JAX einsum
    path on bfloat16 image and filters;
  * the GRU unroll against `GRUCell(dtype=bfloat16)` with `gru_scan`, and the
    spectral-normed conv against `SNConv(dtype=bfloat16)`, gradients
    included.
Tolerances are stated beside each: bfloat16 keeps 8 significant bits, so one
rounding step is 2^-8 = 3.9e-3 of a value; where both sides sum in float32
and round once, they differ by at most that step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from cpcsv_tpu.ops import batchnorm as jax_batchnorm
from cpcsv_tpu.ops.dynamic_filter import dynamic_filter_conv1d as jax_dfn
from cpcsv_tpu.ops.gru import GRUCell as JaxGRUCell
from cpcsv_tpu.ops.gru import gru_scan
from cpcsv_tpu.ops.pallas import bn as pallas_bn
from cpcsv_tpu.ops.spectral_norm import SNConv
from cpcsv_tpu_torch.ops import batchnorm, blocks, dynamic_filter
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.ops.gru import gru_unroll
from cpcsv_tpu_torch.ops.spectral_norm import SNConv2d
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

BF16 = torch.bfloat16
STEP = 2.0 ** -8  # one bfloat16 rounding step, relative


def _bf16(a):
    """numpy float32 values that bfloat16 holds exactly."""
    return torch.from_numpy(a).to(BF16).float().numpy()


def _rel(a, r):
    return float(np.linalg.norm(np.asarray(a, np.float64) - r) / np.linalg.norm(r))


@pytest.mark.parametrize("shape", [(7, 40, 1), (5, 9, 64), (3, 5, 1024)], ids=str)
def test_bn_reductions_read_bf16_as_the_pallas_kernels(shape):
    """(N, C, S) bfloat16: the plain sums in float32 against the Pallas
    kernels' float32 accumulation, within 1e-5 of the sum of the terms'
    magnitudes (the same bfloat16 values, summed in other orders)."""
    N, C, S = shape
    rng = np.random.default_rng(N * C)
    x, dy = _bf16(rng.standard_normal(shape) + 0.5), _bf16(rng.standard_normal(shape))
    mean = rng.standard_normal(C).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, C).astype(np.float32)
    xt, dyt = torch.from_numpy(x).to(BF16), torch.from_numpy(dy).to(BF16)
    ours = bn_cuda.bn_stats_plain(xt) + bn_cuda.bn_grad_reduce_plain(
        xt, dyt, torch.from_numpy(mean), torch.from_numpy(inv))
    rows = lambda a: jnp.asarray(a.transpose(0, 2, 1).reshape(-1, C), jnp.bfloat16)  # noqa: E731
    ref = (pallas_bn.bn_stats(rows(x), interpret=True)
           + pallas_bn.bn_grad_reduce(rows(x), rows(dy), jnp.asarray(mean), jnp.asarray(inv),
                                      interpret=True))
    xhat = (x - mean[:, None]) * inv[:, None]
    magnitude = [np.abs(t).sum(axis=(0, 2)) for t in (x, x * x, dy, dy * xhat)]
    for a, r, m in zip(ours, ref, magnitude):
        assert a.dtype == torch.float32
        assert (np.abs(a.numpy() - np.asarray(r)) <= 1e-5 * m + 1e-6).all()


@pytest.mark.parametrize("shape", [(7, 40), (5, 9, 4, 4)], ids=str)
def test_batch_norm_train_at_bf16_matches_bn_train_core(shape):
    """Train BN of bfloat16 x: y and dx in bfloat16, dscale, dbias and the
    running statistics in float32, against `bn_train_core` with its output
    cast to bfloat16 (dy reaches it as the cast's float32 cotangent)."""
    C = shape[1]
    rng = np.random.default_rng(len(shape))
    x = _bf16(rng.standard_normal(shape) * 1.5 + 0.3)
    w = rng.standard_normal(shape).astype(np.float32)  # loss = sum(w · y)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.standard_normal(C).astype(np.float32)

    bn = (blocks.BatchNorm1d(C) if len(shape) == 2 else blocks.BatchNorm2d(C)).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    y = bn(xt)
    (y * torch.from_numpy(w)).sum().backward()
    assert y.dtype == BF16 and xt.grad.dtype == BF16 and bn.weight.grad.dtype == torch.float32

    to_rows = (lambda a: a) if len(shape) == 2 else (
        lambda a: a.transpose(0, 2, 3, 1).reshape(-1, C))

    def loss(x2d, scale, bias):
        y, _, _ = jax_batchnorm.bn_train_core(x2d, scale, bias, 1e-5, True)
        y = y.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * to_rows(w)), y

    (_, y_ref), (dx, dscale, dbias) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            jnp.asarray(to_rows(x), jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    _, mean, var = jax.jit(lambda *a: jax_batchnorm.bn_train_core(*a, 1e-5, True))(
        jnp.asarray(to_rows(x), jnp.bfloat16), jnp.asarray(scale), jnp.asarray(bias))
    assert y_ref.dtype == dx.dtype == jnp.bfloat16
    # y and dx: float32 arithmetic in other orders, then one rounding to
    # bfloat16: at most one rounding step apart
    for a, r in ((y, y_ref), (xt.grad, dx)):
        a, r = to_rows(a.detach().float().numpy()), np.asarray(r, np.float32)
        np.testing.assert_allclose(a, r, rtol=STEP, atol=1e-6 * np.abs(r).max())
    # float32 sums of the same bfloat16 terms in other orders
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dscale), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dbias), **tol)
    M = to_rows(x).shape[0]
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * np.asarray(mean), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * np.asarray(var) * M / (M - 1),
                               **tol)


def test_batch_norm_train_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        batchnorm.batch_norm_train(torch.zeros(4, 3, dtype=torch.float16), torch.ones(3),
                                   torch.zeros(3), 1e-5)


def test_dfn_plain_at_bf16_matches_jax_einsum():
    """The model's DFN shape (C=3, L=124, K=21, pad 10), bfloat16 image,
    filters and output gradient: output and both gradients in bfloat16. The
    port sums each in float32 and rounds it once, so each lies within one
    rounding step of the exact value (float64 from the same bfloat16
    inputs). The JAX einsum's output and filter gradient are so rounded too:
    they agree with the port's within one step. Its image gradient adds the
    K taps' slices back in bfloat16, rounding more often: it lies further
    from the exact value, and the port's lies within that distance, and one
    step, of it."""
    rng = np.random.default_rng(11)
    B, C, L, K, pad = 5, 3, 124, 21, 10
    image, filters = _bf16(rng.standard_normal((B, C, L))), _bf16(rng.standard_normal((B, 1, C, K)))
    dout = _bf16(rng.standard_normal((B, 1, L)))
    it, ft = (torch.from_numpy(a).to(BF16).requires_grad_() for a in (image, filters))
    out = dynamic_filter.dynamic_filter_conv1d(it, ft, pad)
    out.backward(torch.from_numpy(dout).to(BF16))
    assert out.dtype == it.grad.dtype == ft.grad.dtype == BF16
    exact_in = [torch.from_numpy(a).double() for a in (image, filters, dout)]
    exact = [dynamic_filter.dynamic_filter_conv1d_plain(*exact_in[:2], pad),
             *dynamic_filter.dynamic_filter_conv1d_backward_plain(*exact_in, pad)]

    def f(i, fl):
        return jax_dfn(i, fl, pad, use_pallas=False)

    ref, (di, df) = jax.jit(lambda i, fl, d: (f(i, fl), jax.vjp(f, i, fl)[1](d)))(
        *(jnp.asarray(a, jnp.bfloat16) for a in (image, filters, dout)))
    for what, a, r, e in zip(("out", "d image", "d filters"), (out, it.grad, ft.grad),
                             (ref, di, df), exact):
        a, r, e = a.detach().float().numpy(), np.asarray(r, np.float32), e.numpy()
        assert a.shape == r.shape == e.shape, what
        np.testing.assert_allclose(a, e, rtol=STEP, atol=1e-6 * np.abs(e).max(), err_msg=what)
        if what == "d image":
            assert _rel(a, r) <= _rel(r, e) + STEP, what
        else:
            np.testing.assert_allclose(a, r, rtol=STEP, atol=1e-6 * np.abs(e).max(), err_msg=what)


def test_gru_unroll_at_bf16_matches_jax():
    """Five steps of the motion GRU's cell at bfloat16 (dots, biases, gates in
    bfloat16), from a bfloat16 h0 as m_net's BN gives it: the states and
    the float32 weights' gradients. Each step rounds a few times; the JAX
    cell may keep a product in float32 where the port rounds it, so the two
    drift by a few rounding steps over the unroll: 1.5e-2 in relative L2."""
    B, T, I, H = 3, 5, 10, 6
    rng = np.random.default_rng(12)
    xs = rng.standard_normal((B, T, I)).astype(np.float32)
    h0 = _bf16(rng.standard_normal((B, H)))
    g = rng.standard_normal((B, T, H)).astype(np.float32)
    cell = JaxGRUCell(H, dtype=jnp.bfloat16)
    params = jax.tree.map(np.array, cell.init(jax.random.PRNGKey(0), xs[:, 0], h0))["params"]

    def loss(params):
        hs = gru_scan(lambda x, h: cell.apply({"params": params}, x, h),
                      jnp.asarray(h0, jnp.bfloat16), jnp.asarray(xs))
        return jnp.sum(hs.astype(jnp.float32) * g), hs

    (_, hs_ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    port = nn.GRUCell(I, H)
    with torch.no_grad():
        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh")):
            getattr(port, name).copy_(torch.from_numpy(params[key].T))
        for name, key in (("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
            getattr(port, name).copy_(torch.from_numpy(params[key]))
    hs = gru_unroll(port, torch.from_numpy(h0).to(BF16), torch.from_numpy(xs), BF16)
    (hs.float() * torch.from_numpy(g)).sum().backward()
    assert hs.dtype == BF16 and hs_ref.dtype == jnp.bfloat16
    assert _rel(hs.detach().float().numpy(), np.asarray(hs_ref, np.float32)) <= 1.5e-2
    for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
                      ("bias_hh", "b_hh")):
        ours = getattr(port, name).grad.numpy()
        assert _rel(ours, np.asarray(grads[key]).T if ours.ndim == 2 else grads[key]) <= 1.5e-2


def test_snconv_at_bf16_matches_jax():
    """Two train-mode calls at bfloat16: σ and the power iteration in float32
    on the float32 kernel (u after each call to float32 precision), the conv
    in bfloat16 (the output one rounding step apart, the kernel's float32
    gradient 1e-2 in relative L2: bfloat16 products summed in other orders)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    w_out = rng.standard_normal((2, 4, 4, 7)).astype(np.float32)
    mod = SNConv(7, (4, 4), 2, ((1, 1), (1, 1)), use_bias=True, dtype=jnp.bfloat16)
    variables = jax.tree.map(np.array, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"]["bias"] = rng.standard_normal(7).astype(np.float32)
    conv = SNConv2d(5, 7, 4, 2, 1, bias=True, dtype=BF16)
    with torch.no_grad():
        conv.weight_orig.copy_(torch.from_numpy(variables["params"]["kernel"].transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        conv.weight_u.copy_(torch.from_numpy(variables["spectral"]["u"]))
    spectral = variables["spectral"]

    def loss(params, spectral):
        y, mut = mod.apply({"params": params, "spectral": spectral}, jnp.asarray(x),
                           sn_update=True, mutable=["spectral"])
        return jnp.sum(y.astype(jnp.float32) * w_out), (y, mut["spectral"])

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    for _ in range(2):
        (_, (y_ref, spectral)), g_ref = value_and_grad(variables["params"], spectral)
        conv.weight_orig.grad = conv.bias.grad = None
        y = conv(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        (y.float() * torch.from_numpy(w_out.transpose(0, 3, 1, 2))).sum().backward()
        assert y.dtype == BF16 and conv.weight_orig.grad.dtype == torch.float32
        r = np.asarray(y_ref, np.float32)
        np.testing.assert_allclose(y.detach().float().numpy().transpose(0, 2, 3, 1), r,
                                   rtol=2 * STEP, atol=2 * STEP * np.abs(r).max())
        np.testing.assert_allclose(conv.weight_u.numpy(), np.asarray(spectral["u"]),
                                   rtol=1e-5, atol=1e-6)
        assert _rel(conv.weight_orig.grad.numpy(),
                    np.asarray(g_ref["kernel"]).transpose(3, 2, 0, 1)) <= 1e-2
        assert _rel(conv.bias.grad.numpy(), np.asarray(g_ref["bias"])) <= 1e-2
