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

The `cuda`-marked two-rank check runs the kernels in two gloo ranks sharing
the card (`tests/_torch_parallel_worker.py`), each on its rows of a map, and
holds the all-reduced statistics against one process on the whole map.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.ops import batchnorm, blocks
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.ops.cuda import build
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

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
    ours += bn_cuda.bn_grad_reduce_plain(*map(torch.from_numpy, (x, dy, mean, inv)))
    ref = jax.jit(lambda x, dy, mean, inv: (
        pallas_bn.bn_stats(x, interpret=True)
        + pallas_bn.bn_grad_reduce(x, dy, mean, inv, interpret=True)))(
            jnp.asarray(_rows(x)), jnp.asarray(_rows(dy)), jnp.asarray(mean), jnp.asarray(inv))
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

    (y_ref, mean, var), (dx, dscale, dbias) = jax.jit(lambda *args: (
        jax_batchnorm.bn_train_core(*args, 1e-5, True),
        jax.grad(loss, argnums=(0, 1, 2))(*args)))(
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

    def f(params, x, stats):
        y, mut = flax_bn.apply({"params": params, "batch_stats": stats}, x,
                               use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * y), (y, mut)

    value_and_grad = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    for x in xs:
        (_, (y_ref, mut)), (g_p, g_x) = value_and_grad(params, jnp.asarray(nhwc(x)), stats)
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


def _walk_maps(p, N, C, S):
    """Replays reduce_maps' index arithmetic (csrc/bn.cu) under plan p:
    checks that every channel gets each thread slot 0 ... cluster·tpc − 1
    of its block or cluster once, and returns the reads of each (n, s) by
    those slots' loads, [N, S], stepping (off, s) as the kernel does (the
    same for every channel)."""
    tpc = bn_cuda.THREADS // p.channels
    block, t = np.divmod(np.arange(p.grid * bn_cuda.THREADS), bn_cuda.THREADS)
    group, rank = block // p.cluster, block % p.cluster
    c = group * p.channels + t // tpc
    j = rank * tpc + t % tpc
    inside = c < C
    slots = np.bincount(c[inside] * p.cluster * tpc + j[inside],
                        minlength=C * p.cluster * tpc)
    assert (slots == 1).all()

    sv = S // p.vec
    row, items, stride = C * sv, N * sv, p.cluster * tpc
    j = np.arange(stride)
    dn, ds = divmod(stride, sv)
    s = j % sv
    off = (j // sv) * row + s
    left = np.where(j < items, (items - j + stride - 1) // stride, 0)
    assert left.max() == -(-items // stride)  # the loads of the slowest thread
    reads = np.zeros((N, S), dtype=np.int64)
    for u in range(left.max()):
        live = u < left
        n, col = np.divmod(off[live], row)
        assert (col < sv).all() and (n < N).all()
        for k in range(p.vec):
            np.add.at(reads, (n, col * p.vec + k), 1)
        off = off + dn * row + ds
        s = s + ds
        wrap = s >= sv
        s = np.where(wrap, s - sv, s)
        off = np.where(wrap, off + row - sv, off)
    return reads


def _walk_rows(p, N, C):
    """Replays reduce_rows' index arithmetic: reads of each (n, c), [N, C],
    and the channels whose sums the blocks' first threads write."""
    Q = bn_cuda.ROW_CHANNELS // p.vec
    R = bn_cuda.THREADS // Q
    block, t = np.divmod(np.arange(p.grid * bn_cuda.THREADS), bn_cuda.THREADS)
    q, ty = block * Q + t % Q, t // Q
    live = q < C // p.vec
    flat = []
    for k in range(-(-N // R)):
        n = ty + k * R
        m = live & (n < N)
        flat += [n[m] * C + q[m] * p.vec + lane for lane in range(p.vec)]
    reads = np.bincount(np.concatenate(flat), minlength=N * C).reshape(N, C)
    written = block * bn_cuda.ROW_CHANNELS + t
    return reads, written[(t < bn_cuda.ROW_CHANNELS) & (written < C)]


# final.yml's D+G step at IM_BATCH 90 / ST_BATCH 18: every (N, C, S) it gives
# the BN kernels (chip_smoke.py phase 6 counts them)
STEP_SHAPES = [
    (17, 992, 16), (18, 124, 1), (18, 365, 1), (18, 992, 16), (89, 992, 16), (90, 63, 1),
    (90, 64, 4096), (90, 124, 1), (90, 128, 1024), (90, 128, 4096), (90, 248, 256),
    (90, 256, 256), (90, 256, 1024), (90, 365, 1), (90, 372, 1), (90, 496, 64), (90, 512, 64),
    (90, 512, 256), (90, 992, 16), (90, 1024, 64), (90, 16384, 1), (90, 32768, 1)]
# the same widths at N=7, and edge shapes: one row, one channel, S not a
# multiple of 4, odd short maps, the dense heads at S = 1
PLAN_SHAPES = (STEP_SHAPES + sorted({(7, c, s) for _, c, s in STEP_SHAPES})
               + [(1, 64, 4096), (90, 1, 1024), (7, 37, 5), (3, 5, 18), (2, 3, 2),
                  (18, 16384, 1), (90, 9, 1), (1, 1, 1)])
H100_SMS = 132


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_element_once(shape, aligned):
    N, C, S = shape
    p = bn_cuda.plan(N, C, S, H100_SMS, aligned)
    assert 1 <= p.grid <= bn_cuda.GRID_MAX and p.grid % p.cluster == 0
    assert 1 <= p.cluster <= bn_cuda.MAX_CLUSTER
    assert p.vec in (1, 4)
    if p.vec == 4:  # 16-byte loads only where every load is 16-byte aligned
        assert aligned and (C if S == 1 else S) % 4 == 0
    if S == 1:
        assert p.cluster == 1 and p.channels == bn_cuda.ROW_CHANNELS
        assert p.grid == -(-C // p.channels)
        reads, written = _walk_rows(p, N, C)
        assert (reads == 1).all() and (written == np.arange(C)).all()
        return
    assert p.channels in (1, 2, 4, 8)
    assert p.cluster == 1 or p.channels == 1  # a cluster reduces one channel
    assert p.grid == -(-C // p.channels) * p.cluster
    # about BLOCKS_PER_SM blocks an SM (twice that at most, from rounding),
    # unless C alone needs more, at 8 channels a block
    assert p.grid <= max(2 * bn_cuda.BLOCKS_PER_SM * H100_SMS, -(-C // 8))
    assert (_walk_maps(p, N, C, S) == 1).all()


# the same widths at throughput.yml's batches (IM_BATCH 360, ST_BATCH 72),
# bfloat16, beside the edge shapes
BF16_PLAN_SHAPES = ([({17: 71, 18: 72, 89: 359, 90: 360}[n], c, s) for n, c, s in STEP_SHAPES]
                    + PLAN_SHAPES[len(STEP_SHAPES):])


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", BF16_PLAN_SHAPES, ids=str)
def test_bf16_plan_covers_every_element_once(shape, aligned):
    """bfloat16: 16-byte loads are 8 elements, so a load covers twice the
    elements it does in float32; every element is still read once."""
    N, C, S = shape
    p = bn_cuda.plan(N, C, S, H100_SMS, aligned, itemsize=2)
    assert p.vec in (1, 8)
    if p.vec == 8:
        assert aligned and (C if S == 1 else S) % 8 == 0
    if S == 1:
        reads, written = _walk_rows(p, N, C)
        assert (reads == 1).all() and (written == np.arange(C)).all()
        return
    assert p.grid == -(-C // p.channels) * p.cluster
    assert (_walk_maps(p, N, C, S) == 1).all()


# USE_SEQ_CONSISTENCY's VideoEncoder at ST_BATCH 18 (float32) and 72
# (bfloat16): 5-D maps as (N, C, T·H·W), C = 45 and S down to 4 and 1 (S = 4
# is no multiple of the 8-element bf16 load; (18, 45, 4) has neither C nor S
# one); and USE_INFONCE's pairwise head at IM_BATCH 90 (8100 = 90² rows) and
# ST_BATCH 18 (324)
VIDEO_SHAPES = [(18, 45, 5120), (18, 64, 7168), (18, 128, 1792), (18, 128, 1024),
                (18, 128, 256), (18, 256, 128), (18, 256, 32), (18, 512, 16), (18, 512, 4),
                (18, 128, 1), (72, 45, 5120), (72, 512, 4), (18, 45, 4)]
INFONCE_SHAPES = [(8100, 992, 16), (324, 992, 16)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", VIDEO_SHAPES + INFONCE_SHAPES, ids=str)
def test_plan_covers_the_objectives_maps(shape, aligned, itemsize):
    """Every element of the VideoEncoder's and InfoNCE's maps read once, with
    16-byte loads only where the row allows them."""
    N, C, S = shape
    p = bn_cuda.plan(N, C, S, H100_SMS, aligned, itemsize=itemsize)
    wide = 16 // itemsize
    assert p.vec in (1, wide)
    if p.vec == wide:
        assert aligned and (C if S == 1 else S) % wide == 0
    if S == 1:
        reads, written = _walk_rows(p, N, C)
        assert (reads == 1).all() and (written == np.arange(C)).all()
        return
    assert p.grid == -(-C // p.channels) * p.cluster
    assert (_walk_maps(p, N, C, S) == 1).all()


def test_bf16_plan_sizes_work_in_16_byte_loads():
    # the largest bfloat16 map of a throughput.yml step reads as many 16-byte
    # loads as the float32 one of final.yml at a quarter of the batch
    bf16 = bn_cuda.plan(360, 128, 4096, H100_SMS, True, itemsize=2)
    assert bf16 == bn_cuda.Plan(8, 256, 2, 1)
    assert bf16._replace(vec=4) == bn_cuda.plan(180, 128, 4096, H100_SMS, True)
    assert bn_cuda.plan(360, 32768, 1, H100_SMS, True, itemsize=2) == bn_cuda.Plan(8, 1024, 1, 32)
    assert bn_cuda.plan(360, 124, 1, H100_SMS, True, itemsize=2).vec == 1  # 124 % 8 != 0
    with pytest.raises(ValueError):
        bn_cuda.plan(4, 4, 4, H100_SMS, True, itemsize=8)


def test_plan_follows_the_card_and_the_alignment():
    # the largest maps of the step: a cluster of 2 blocks a channel, float4
    assert bn_cuda.plan(90, 128, 4096, H100_SMS, True) == bn_cuda.Plan(4, 256, 2, 1)
    # C = 64: a cluster of 4; C = 256, a block a channel
    assert bn_cuda.plan(90, 64, 4096, H100_SMS, True).cluster == 4
    assert bn_cuda.plan(90, 256, 1024, H100_SMS, True) == bn_cuda.Plan(4, 256, 1, 1)
    # short maps: two warps a channel, four channels a block
    assert bn_cuda.plan(90, 992, 16, H100_SMS, True) == bn_cuda.Plan(4, 248, 1, 4)
    # twice the SMs, twice the blocks; unaligned, scalar loads
    assert bn_cuda.plan(90, 128, 4096, 2 * H100_SMS, True).cluster == 4
    assert bn_cuda.plan(90, 128, 4096, H100_SMS, False).vec == 1
    # the dense heads: 32 channels a block, as float4s over 32 row groups or
    # as floats over 8
    assert bn_cuda.plan(90, 32768, 1, H100_SMS, True) == bn_cuda.Plan(4, 1024, 1, 32)
    assert bn_cuda.plan(90, 9, 1, H100_SMS, True) == bn_cuda.Plan(1, 1, 1, 32)
    with pytest.raises(ValueError):
        bn_cuda.plan(0, 4, 4, H100_SMS, True)


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
    # the step's shapes at full width (final.yml), and odd ones; each 16-byte
    # aligned and one float off, so every plan variant runs: rows with float4
    # and floats, maps with a warp to a block a channel and with clusters,
    # float4 and floats (S % 4 != 0 or unaligned)
    shapes = [(90, 32768, 1), (18, 992, 16), (89, 992, 16), (90, 248, 256), (90, 1024, 64),
              (90, 512, 64), (90, 128, 4096), (7, 128, 4096), (1, 64, 4096), (90, 1, 1024),
              (40, 992, 16), (7, 37, 5), (3, 5, 18), (90, 9, 1), (1, 5, 1)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = set()
    for (N, C, S), offset in ((sh, off) for sh in shapes for off in (0, 1)):
        gen = torch.Generator(device="cuda").manual_seed(N * C + S)
        buf = torch.randn(2, N * C * S + 4, generator=gen, device="cuda")
        x, dy = (row[offset:offset + N * C * S].view(N, C, S) for row in buf)
        x += 0.5
        mean = torch.randn(C, generator=gen, device="cuda")
        inv = torch.rand(C, generator=gen, device="cuda") + 0.5
        p = bn_cuda.plan(N, C, S, sms, offset == 0)
        assert (x.data_ptr() % 16 == 0) == (offset == 0)
        variants.add(("rows" if S == 1 else "maps", p.vec, p.cluster > 1, p.channels))
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
    assert {v[:3] for v in variants} >= {("rows", 4, False), ("rows", 1, False),
                                         ("maps", 4, False), ("maps", 4, True),
                                         ("maps", 1, False), ("maps", 1, True)}
    assert {v[3] for v in variants if v[0] == "maps"} == {1, 2, 4, 8}


@pytest.mark.cuda
def test_cuda_kernels_match_plain_bf16():
    """bfloat16 x and dy at the throughput.yml step's shapes (IM_BATCH 360,
    ST_BATCH 72) and odd ones, each 16-byte aligned and one element off, so
    that every load width runs: 8 bfloat16s and one. The float32 sums of the
    kernels against the plain versions on the upcast inputs in float64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shapes = [(360, 32768, 1), (72, 992, 16), (359, 992, 16), (360, 248, 256),
              (360, 1024, 64), (360, 128, 4096), (7, 128, 4096), (1, 64, 4096), (360, 1, 1024),
              (7, 37, 5), (3, 5, 18), (360, 9, 1), (360, 124, 1), (1, 5, 1)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    variants = set()
    for (N, C, S), offset in ((sh, off) for sh in shapes for off in (0, 1)):
        gen = torch.Generator(device="cuda").manual_seed(N * C + S)
        buf = torch.randn(2, N * C * S + 8, generator=gen, device="cuda").to(torch.bfloat16)
        x, dy = (row[offset:offset + N * C * S].view(N, C, S) for row in buf)
        x += 0.5
        mean = torch.randn(C, generator=gen, device="cuda")
        inv = torch.rand(C, generator=gen, device="cuda") + 0.5
        p = bn_cuda.plan(N, C, S, sms, offset == 0, itemsize=2)
        variants.add(("rows" if S == 1 else "maps", p.vec, p.cluster > 1))
        got = bn_cuda.bn_stats(x) + bn_cuda.bn_grad_reduce(x, dy, mean, inv)
        again = bn_cuda.bn_stats(x) + bn_cuda.bn_grad_reduce(x, dy, mean, inv)
        torch.cuda.synchronize()
        xd, dyd = x.double(), dy.double()
        ref = bn_cuda.bn_stats_plain(xd) + bn_cuda.bn_grad_reduce_plain(
            xd, dyd, mean.double(), inv.double())
        xhat = (xd - mean.double()[:, None]) * inv.double()[:, None]
        magnitude = [t.abs().sum(dim=(0, 2)) for t in (xd, xd * xd, dyd, dyd * xhat)]
        for a, b, r, m in zip(got, again, ref, magnitude):
            assert a.dtype == torch.float32 and torch.equal(a, b)
            # float32 sums of up to 1.5M bfloat16 terms against float64, where
            # the terms cancel: within 1e-5 of the sum of their magnitudes
            assert ((a.double() - r).abs() <= 1e-5 * m + 1e-6).all()
    assert variants >= {("rows", 8, False), ("rows", 1, False), ("maps", 8, False),
                        ("maps", 8, True), ("maps", 1, False), ("maps", 1, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_cuda_kernels_at_the_video_encoder_maps(dtype):
    """The VideoEncoder's BN maps as the model gives them, 5-D, through
    BatchNorm3d (C = 45 at S = 5120, C = 512 at S = 4, and (18, 45, 4)), the
    kernels in train mode forward and backward against the same module on
    the plain versions: output, input gradient, scale and bias gradients,
    running statistics. float32 sums in other orders; at bfloat16 the
    output and dx round once either way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for shape in [(18, 45, 5, 32, 32), (18, 512, 1, 2, 2), (18, 45, 1, 2, 2), (18, 128, 4, 8, 8)]:
        gen = torch.Generator(device="cuda").manual_seed(sum(shape))
        x = (torch.randn(shape, generator=gen, device="cuda") * 1.5 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        out = {}
        for route in ("kernel", "plain"):
            bn = blocks.BatchNorm3d(shape[1]).cuda().train()
            xi = x.clone().requires_grad_()
            before = dict(bn_cuda.launches)
            if route == "plain":
                with mock.patch.object(batchnorm, "bn_stats", bn_cuda.bn_stats_plain), \
                        mock.patch.object(batchnorm, "bn_grad_reduce",
                                          bn_cuda.bn_grad_reduce_plain):
                    y = bn(xi)
                    y.backward(dy)
            else:
                y = bn(xi)
                y.backward(dy)
            torch.cuda.synchronize()
            launched = {k: bn_cuda.launches[k] - before[k] for k in before}
            assert launched == ({"bn_stats": 1, "bn_grad_reduce": 1} if route == "kernel"
                                else {"bn_stats": 0, "bn_grad_reduce": 0})
            assert y.dtype == dtype and xi.grad.dtype == dtype
            out[route] = [t.float() for t in (y, xi.grad, bn.weight.grad, bn.bias.grad,
                                               bn.running_mean, bn.running_var)]
        for a, r in zip(out["kernel"], out["plain"]):
            torch.testing.assert_close(a, r, **tol)


@pytest.mark.cuda
def test_cuda_bn_sums_all_reduced_across_two_ranks(tmp_path):
    """Two gloo ranks sharing the card, each a process running the BN kernels on
    its rows of a full-width map (the step's (18, 992, 4x4) and (90, 128,
    8x8), split evenly; and (9, 64, 8x8) all on rank 0, rank 1's map empty):
    the forward's (s, q, M) and the backward's (sdy, sdyx) all-reduced. Each
    rank's y and dx against one process's rows of the whole map, the ranks'
    dscale and dbias added against one process's, the running statistics
    equal on both ranks and close to one process's; one launch of each
    kernel a rank with rows, none on an empty map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import os
    import sys

    rng = np.random.default_rng(3)
    cases = []
    for (N, C, H), split in (((18, 992, 4), None), ((90, 128, 8), None), ((9, 64, 8), "rank 0")):
        x = (rng.standard_normal((N, C, H, H)) * 1.5 + 0.5).astype(np.float32)
        w = rng.standard_normal((N, C, H, H)).astype(np.float32)
        cases.append({"x": x, "w": w, "split": [N, 0] if split else [N // 2, N - N // 2]})
    job_path = tmp_path / "job.pt"
    torch.save({"root": str(tmp_path), "device": "cuda", "bn": cases}, job_path)
    import _torch_parallel_worker as worker

    logs = [tmp_path / f"rank{rank}.log" for rank in range(2)]
    procs = worker.start_ranks(
        [[sys.executable, worker.__file__, "bn", str(rank), "2",
          f"file://{tmp_path / 'rendezvous'}", str(job_path), str(tmp_path / f"rank{rank}.pt")]
         for rank in range(2)], logs, [{**os.environ}] * 2)
    # the ranks together, a failed one ending both at once; a launch takes
    # ~10-20 s on the card
    worker.wait_ranks(procs, logs, 120, "the two BN ranks")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["cases"] for r in range(2)]
    for i, case in enumerate(cases):
        r0, r1 = ranks[0][i], ranks[1][i]
        one = blocks.BatchNorm2d(case["x"].shape[1]).cuda().train()
        x = torch.from_numpy(case["x"]).cuda().requires_grad_()
        y = one(x)
        (y * torch.from_numpy(case["w"]).cuda()).sum().backward()
        n0 = case["split"][0]
        ref = {"y": y.detach().cpu().numpy(), "dx": x.grad.cpu().numpy()}
        for key in ("y", "dx"):  # float32 sums over the ranks in another order
            scale = np.abs(ref[key]).max()
            np.testing.assert_allclose(np.concatenate([r0[key], r1[key]]), ref[key],
                                       rtol=1e-4, atol=1e-5 * scale, err_msg=f"case {i} {key}")
            assert r1[key].shape[0] == case["split"][1]
        for key, grad in (("dscale", one.weight.grad), ("dbias", one.bias.grad)):
            np.testing.assert_allclose(r0[key] + r1[key], grad.cpu().numpy(), rtol=1e-4,
                                       atol=1e-5 * float(grad.abs().max()), err_msg=key)
        for key in ("running_mean", "running_var"):
            np.testing.assert_array_equal(r0[key], r1[key])
            np.testing.assert_allclose(r0[key], getattr(one, key).cpu().numpy(), rtol=1e-5,
                                       atol=1e-6)
        assert r0["launches"] == {"bn_stats": 1, "bn_grad_reduce": 1}
        assert r1["launches"] == ({"bn_stats": 0, "bn_grad_reduce": 0} if n0 == len(case["x"])
                                  else {"bn_stats": 1, "bn_grad_reduce": 1})
