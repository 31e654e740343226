"""The port's dynamic-filter conv1d (`cpcsv_tpu_torch/ops/dynamic_filter.py`).

On the CPU, its plain version is held against the JAX package's einsum path
and its Pallas kernel in interpret mode, at the model's shape (C=3, L=124,
K=21, pad 10), at K=7, at a K without a compile-time kernel (5) and with
L_out != L (K=21, pad 0), for odd batches, and the plain backward against
`jax.vjp` of the einsum path. The kernels' launch plans are walked in numpy
(every output computed once), and the autograd Function's handling of a
row-strided dout is checked with a stand-in kernel. The CUDA kernels,
forward and backward, are held against the plain versions in the
`cuda`-marked tests, which skip without a card; JAX is reached through a
fixture, so those tests run where JAX is absent:

    python -m pytest tests/test_torch_dfn.py -m cuda
"""

import itertools
import types

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.ops import dynamic_filter
from cpcsv_tpu_torch.ops.cuda import build
from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

C, L = 3, 124
# (B, K, pad): the model's taps, K=7, a runtime-K shape, L_out != L
SHAPES = [(1, 21, 10), (7, 21, 10), (1, 7, 3), (7, 7, 3), (3, 5, 2), (3, 21, 0)]


def _inputs(B, K, seed, O=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, C, L)).astype(np.float32),
            rng.standard_normal((B, O, C, K)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_dfn():
    """(einsum path, Pallas kernel in interpret mode) of the JAX package,
    jitted."""
    pytest.importorskip("jax")
    from cpcsv_tpu.ops.dynamic_filter import dynamic_filter_conv1d
    from cpcsv_tpu.ops.pallas.dfn import dfn_pallas

    import jax

    return (
        jax.jit(lambda img, filt, pad: dynamic_filter_conv1d(img, filt, pad, use_pallas=False),
                static_argnums=2),
        jax.jit(lambda img, filt, pad: dfn_pallas(img, filt, pad, interpret=True),
                static_argnums=2),
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


@pytest.mark.parametrize("B,K,pad", SHAPES)
def test_plain_backward_matches_jax_grad(jax_dfn, B, K, pad):
    import jax
    import jax.numpy as jnp

    image, filters = _inputs(B, K, seed=B * 10 + K)
    dout = np.random.default_rng(B + K).standard_normal((B, 1, L + 2 * pad - K + 1)).astype(
        np.float32)
    ours = dynamic_filter.dynamic_filter_conv1d_backward_plain(
        *(torch.from_numpy(a) for a in (image, filters, dout)), pad)
    grads = jax.jit(lambda i, f, d: jax.vjp(lambda i, f: jax_dfn[0](i, f, pad), i, f)[1](d))(
        jnp.asarray(image), jnp.asarray(filters), jnp.asarray(dout))
    for a, r in zip(ours, grads):
        # float32 sums of up to 124 products in other orders
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)


def test_cpu_call_never_builds(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor must not build the CUDA kernel")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    before = dict(dfn_cuda.launches)
    image, filters = (torch.from_numpy(a).requires_grad_() for a in _inputs(2, 21, seed=4))
    out = dynamic_filter.dynamic_filter_conv1d(image, filters, 10)
    assert out.shape == (2, 1, L)
    out.sum().backward()  # the CPU gradient is autograd of the plain version
    assert image.grad.shape == image.shape and filters.grad.shape == filters.shape
    # the kernels' wrappers themselves refuse CPU tensors before they would
    # build anything
    with pytest.raises(ValueError, match="CUDA"):
        dfn_cuda.dfn_forward(image.detach(), filters.detach(), 10)
    with pytest.raises(ValueError, match="CUDA"):
        dfn_cuda.dfn_backward(image.detach(), filters.detach(), out.detach(), 10)
    assert dfn_cuda.launches == before


# the batches of the main paths (90 a training call or an 18-story serving
# call, 360 a 72-story call), one sample, a few, and 1,440
BATCHES = (1, 7, 90, 360, 1440)
TAPS = sorted({(K, pad) for _, K, pad in SHAPES})
H100_SMS = 132


def _writes(p, B, K, pad, backward):
    """Replays csrc/dfn.cu's index arithmetic under plan p: how often each
    output is written, [items, outputs] with items B (forward) or B·C
    (backward, the outputs then d image's L and d filters' K)."""
    L_out = L + 2 * pad - K + 1
    items = B * C if backward else B
    item = np.arange(p.grid * p.warps)  # blockIdx.x * warps + warp
    item = item[item < items]

    def columns(n):  # lane l writes x0 .. x0 + 3 for x0 = 4l, 4l + 128, ... < n
        x0 = (dfn_cuda.OUTPUTS_PER_LANE * np.arange(dfn_cuda.LANES)[:, None]
              + dfn_cuda.CHUNK * np.arange(-(-n // dfn_cuda.CHUNK))[None, :]).ravel()
        x = (x0[x0 < n][:, None] + np.arange(dfn_cuda.OUTPUTS_PER_LANE)).ravel()
        return np.bincount(x[x < n], minlength=n)

    if not backward:
        cols = columns(L_out)
    elif p.taps:  # lane k < K writes tap k after the reduce-scatter
        assert p.taps <= dfn_cuda.LANES
        lanes = np.arange(dfn_cuda.LANES)
        cols = np.concatenate([columns(L), np.bincount(lanes[lanes < K], minlength=K)])
    else:  # lane 0 writes every tap
        cols = np.concatenate([columns(L), np.ones(K, dtype=np.int64)])
    writes = np.zeros((items, len(cols)), dtype=np.int64)
    np.add.at(writes, item, cols)
    return writes


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("K,pad", TAPS, ids=str)
@pytest.mark.parametrize("B", BATCHES)
def test_plan_computes_every_output_once(B, K, pad, backward):
    items = B * C if backward else B
    for aligned in (True, False):
        p = dfn_cuda.plan(B, C, L, K, pad, H100_SMS, aligned, backward)
        assert 1 <= p.warps <= dfn_cuda.MAX_WARPS and 1 <= p.grid <= dfn_cuda.GRID_MAX
        assert (p.grid - 1) * p.warps < items <= p.grid * p.warps  # no idle block
        assert 4 * p.warps * dfn_cuda.warp_floats(C, L, K, pad, backward) <= dfn_cuda.SMEM_LIMIT
        assert p.vec == (4 if aligned else 1)  # L = 124 is a multiple of 4
        assert p.taps == (K if (C, K) in dfn_cuda.INSTANTIATIONS else 0)
        assert (_writes(p, B, K, pad, backward) == 1).all()


def test_plan_follows_the_batch_and_the_card():
    # a training call or an 18-story serving call: a warp a block, a block a
    # sample; 72 stories: 3 samples a block; the step's backward: a warp a
    # (sample, channel), 3 a block
    assert dfn_cuda.plan(90, 3, 124, 21, 10, H100_SMS, True) == dfn_cuda.Plan(1, 90, 4, 21)
    assert dfn_cuda.plan(360, 3, 124, 21, 10, H100_SMS, True) == dfn_cuda.Plan(3, 120, 4, 21)
    assert dfn_cuda.plan(1440, 3, 124, 21, 10, H100_SMS, True) == dfn_cuda.Plan(8, 180, 4, 21)
    assert dfn_cuda.plan(90, 3, 124, 21, 10, H100_SMS, True, True) == dfn_cuda.Plan(3, 90, 4, 21)
    assert dfn_cuda.plan(7, 3, 124, 21, 10, H100_SMS, True, True) == dfn_cuda.Plan(1, 21, 4, 21)
    assert dfn_cuda.plan(360, 3, 124, 21, 10, 2 * H100_SMS, True).warps == 2
    # no 16-byte rows unless aligned and L % 4 == 0; the runtime-K kernel
    # for shapes without an instantiation
    assert dfn_cuda.plan(90, 3, 123, 21, 10, H100_SMS, True).vec == 1
    assert dfn_cuda.plan(90, 3, 124, 5, 2, H100_SMS, True).taps == 0
    assert dfn_cuda.plan(90, 4, 124, 21, 10, H100_SMS, True).taps == 0
    # fewer warps where a block's shared memory would not hold them; none
    # where one warp's rows do not fit
    wide = dfn_cuda.plan(1440, 3, 4096, 21, 10, H100_SMS, True)
    assert wide.warps * 4 * dfn_cuda.warp_floats(3, 4096, 21, 10, False) <= dfn_cuda.SMEM_LIMIT
    assert wide.warps < dfn_cuda.MAX_WARPS
    with pytest.raises(ValueError, match="shared memory"):
        dfn_cuda.plan(90, 3, 100_000, 21, 10, H100_SMS, True)
    with pytest.raises(ValueError):
        dfn_cuda.plan(0, 3, 124, 21, 10, H100_SMS, True)


def test_launch_passes_every_plan_field(monkeypatch):
    calls = []
    monkeypatch.setattr(dfn_cuda, "_library", lambda: types.SimpleNamespace(
        dfn_forward="forward", dfn_backward="backward"))
    monkeypatch.setattr(dfn_cuda, "_call", lambda fn, device, *args: calls.append((fn, args)) or 0)
    monkeypatch.setattr(dfn_cuda, "launches", {"dfn_forward": 0, "dfn_backward": 0})
    B, K, pad = 4, 21, 10
    image, filters = (torch.from_numpy(a) for a in _inputs(B, K, seed=5))
    dout = torch.zeros(B, 613)[:, 613 - L:].unsqueeze(1)
    p = dfn_cuda.Plan(warps=3, grid=2, vec=1, taps=21)  # distinct values
    dfn_cuda.launch_forward(p, image, filters, pad)
    dfn_cuda.launch_backward(p, image, filters, dout, pad)
    (fn_f, args_f), (fn_b, args_b) = calls
    # csrc/dfn.cu: dfn_forward(img, filt, out, B, C, L, K, pad, dtype, warps,
    # grid, vec, taps, stream)
    assert fn_f == "forward" and len(args_f) == 13
    assert args_f[3:9] == (B, C, L, K, pad, 0) and args_f[9:] == tuple(p)
    # dfn_backward(img, filt, dout, dimg, dfilt, B, C, L, K, pad, dout_stride,
    # dtype, warps, grid, vec, taps, stream)
    assert fn_b == "backward" and len(args_b) == 16 and args_b[2] == dout.data_ptr()
    assert args_b[5:12] == (B, C, L, K, pad, 613, 0) and args_b[12:] == tuple(p)
    assert dfn_cuda.launches == {"dfn_forward": 1, "dfn_backward": 1}


def test_row_strided_dout_gives_the_contiguous_gradients():
    B, K, pad = 4, 21, 10
    # dout as the G step makes it: the columns of a (B, 613) concatenation's
    # gradient that belong to the DFN output, rows 613 floats apart
    grad = torch.from_numpy(np.random.default_rng(6).standard_normal((B, 613)).astype(np.float32))
    strided = grad[:, 613 - L:].unsqueeze(1)
    assert strided.stride()[0] == 613 and not strided.is_contiguous()
    grads = []
    for dout in (strided, strided.contiguous()):
        image, filters = (torch.from_numpy(a).requires_grad_() for a in _inputs(B, K, seed=7))
        out = dynamic_filter.dynamic_filter_conv1d(image, filters, pad)
        grads.append(torch.autograd.grad(out, (image, filters), dout))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_kernel_function_copies_only_a_strided_length(monkeypatch):
    seen = []

    def kernel(image, filters, dout, pad):
        seen.append((dout.data_ptr(), dout.stride()))
        return torch.zeros_like(image), torch.zeros_like(filters)

    monkeypatch.setattr(dfn_cuda, "dfn_backward", kernel)
    B = 4
    image, filters = (torch.from_numpy(a) for a in _inputs(B, 21, seed=8))
    ctx = types.SimpleNamespace(saved_tensors=(image, filters), pad=10)
    backward = dynamic_filter._DynamicFilterKernel.backward
    strided = torch.zeros(B, 613)[:, 613 - L:].unsqueeze(1)
    backward(ctx, strided)
    assert seen[-1] == (strided.data_ptr(), strided.stride())  # handed on, no copy
    for dout in (torch.zeros(B, 1, 2 * L)[..., ::2], torch.ones(1, 1, 1).expand(B, 1, L)):
        backward(ctx, dout)  # every other float, and a broadcast: copied
        assert seen[-1][0] != dout.data_ptr() and seen[-1][1] == (L, L, 1)


def _misaligned(a: np.ndarray, dtype) -> torch.Tensor:
    """`a` on the card, contiguous, starting one element past a 16-byte
    boundary, so that no row can be read with 16-byte loads."""
    buf = torch.empty(a.size + 1, device="cuda", dtype=dtype)
    view = buf[1:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_kernel_matches_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for (K, pad), B, offset in itertools.product(TAPS, BATCHES, (0, 1)):
        arrays = _inputs(B, K, seed=B)
        if offset:  # every instantiation also on rows read element by element
            image, filters = (_misaligned(a, dtype) for a in arrays)
        else:
            image, filters = (torch.from_numpy(a).cuda().to(dtype) for a in arrays)
        before = dfn_cuda.launches["dfn_forward"]
        out = dynamic_filter.dynamic_filter_conv1d(image, filters, pad)
        torch.cuda.synchronize()
        assert dfn_cuda.launches["dfn_forward"] == before + 1 and out.dtype == dtype
        ref = dynamic_filter.dynamic_filter_conv1d_plain(image.float(), filters.float(), pad)
        # f32: the sum order differs; bf16: one rounding of the output
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
        assert torch.equal(out, dfn_cuda.dfn_forward(image, filters, pad))  # the same bits


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for (K, pad), B, offset in itertools.product(TAPS, BATCHES, (0, 1)):
        arrays = _inputs(B, K, seed=B + 1)
        if offset:
            image, filters = (_misaligned(a, torch.float32) for a in arrays)
        else:
            image, filters = (torch.from_numpy(a).cuda() for a in arrays)
        image.requires_grad_()
        filters.requires_grad_()
        L_out = L + 2 * pad - K + 1
        # a row-strided dout, as the G step hands it over, and its copy
        strided = torch.randn(B, 613, device="cuda")[:, 613 - L_out:].unsqueeze(1)
        dout = strided.contiguous()
        before = dfn_cuda.launches["dfn_backward"]
        dynamic_filter.dynamic_filter_conv1d(image, filters, pad).backward(dout)
        torch.cuda.synchronize()
        assert dfn_cuda.launches["dfn_backward"] == before + 1
        ref = dynamic_filter.dynamic_filter_conv1d_backward_plain(image, filters, dout, pad)
        for got, want in zip((image.grad, filters.grad), ref):
            # float32, sums of up to 124 products in another order
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        got = dfn_cuda.dfn_backward(image.detach(), filters.detach(), strided, pad)
        again = dfn_cuda.dfn_backward(image.detach(), filters.detach(), strided, pad)
        for a, b, c in zip(got, again, (image.grad, filters.grad)):
            assert torch.equal(a, b) and torch.equal(a, c)  # the same bits, strided or not


@pytest.mark.cuda
def test_cuda_backward_matches_plain_bf16():
    """bfloat16 image, filters and row-strided dout, as the G step hands them
    over at COMPUTE_DTYPE bfloat16: bfloat16 gradients, summed in float32
    and rounded once, against the plain backward on the upcast inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for (K, pad), B, offset in itertools.product(TAPS, BATCHES, (0, 1)):
        arrays = _inputs(B, K, seed=B + 2)
        if offset:
            image, filters = (_misaligned(a, torch.bfloat16) for a in arrays)
        else:
            image, filters = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in arrays)
        image.requires_grad_()
        filters.requires_grad_()
        L_out = L + 2 * pad - K + 1
        strided = torch.randn(B, 613, device="cuda").to(torch.bfloat16)[:, 613 - L_out:]
        strided = strided.unsqueeze(1)
        before = dfn_cuda.launches["dfn_backward"]
        dynamic_filter.dynamic_filter_conv1d(image, filters, pad).backward(strided)
        torch.cuda.synchronize()
        assert dfn_cuda.launches["dfn_backward"] == before + 1
        ref = dynamic_filter.dynamic_filter_conv1d_backward_plain(
            image.detach().float(), filters.detach().float(), strided.float(), pad)
        for got, want in zip((image.grad, filters.grad), ref):
            assert got.dtype == torch.bfloat16
            # one rounding to bfloat16 of float32 sums: 2^-8 relative
            torch.testing.assert_close(got.float(), want, rtol=2**-8, atol=1e-3)
        got = dfn_cuda.dfn_backward(image.detach(), filters.detach(), strided, pad)
        again = dfn_cuda.dfn_backward(image.detach(), filters.detach(), strided.contiguous(), pad)
        for a, b, c in zip(got, again, (image.grad, filters.grad)):
            assert torch.equal(a, b) and torch.equal(a, c)  # the same bits, strided or not
