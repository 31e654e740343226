"""The port's nearest-2x upsample + conv3x3 lowerings (`cpcsv_tpu_torch/ops/
fused_upsample.py`, cfg.FUSED_UPSAMPLE) against the JAX package's
(`cpcsv_tpu/ops/fused_upsample.py`, `ops/blocks.py:Conv3x3`).

Each of "off", "deconv", "parity4" and "parity1" runs through `UpBlock.
upsample_conv` on the same numpy input, weight and output gradient as the
JAX Conv3x3 with that `fuse_upsample2x`, in float32 and at bfloat16 compute:
the output, d input and d weight (through the weight's cast, as JAX
differentiates `kernel.astype(dtype)`). The parity and composite kernels are
summed from the cast weight on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpcsv_tpu.ops import blocks as jax_blocks
from cpcsv_tpu_torch.ops import blocks, fused_upsample
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

N, H, W, CIN, COUT = 2, 5, 4, 6, 5  # odd H, W != H: every pad and slice shows
LOWERINGS = ["off", "deconv", "parity4", "parity1"]
# Relative L2 distance of each result from JAX's, and its largest error over
# the result's largest magnitude. float32: the convolutions sum up to 9·CIN
# products in other orders, about 1e-7. bfloat16: each output is rounded to
# bfloat16 (2^-8 = 3.9e-3 relative) after sums in other orders, so the two
# roundings differ by one bfloat16 step where a sum lies near a rounding
# boundary; and the gradients are such rounded outputs summed again.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (5e-3, 2**-7)}
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _data(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H, W, CIN)).astype(np.float32)
    w = (rng.standard_normal((3, 3, CIN, COUT)) / np.sqrt(9 * CIN)).astype(np.float32)
    g = rng.standard_normal((N, 2 * H, 2 * W, COUT)).astype(np.float32)
    return x, w, g


_JAX = {}  # (lowering, dtype) -> jitted (y, dx, dw), traced once a module


def jax_upsample_conv(fused, dtype, x, w, g):
    """The JAX Conv3x3 of an UpBlock at `dtype`: upsample then conv ("off"),
    or fused; loss sum(y·g) for the gradients."""
    key = (fused, dtype)
    if key not in _JAX:
        conv = jax_blocks.Conv3x3(COUT, dtype=DTYPES[dtype], fuse_upsample2x=fused)

        def f(x, w):
            xin = x if fused != "off" else jax_blocks.nearest_upsample_2x(x)
            return conv.apply({"params": {"kernel": w}}, xin)

        def fwd_bwd(x, w, g):
            y, vjp = jax.vjp(f, x, w)
            return (y,) + vjp(g.astype(y.dtype))

        _JAX[key] = jax.jit(fwd_bwd)
    with jax.default_matmul_precision("highest"):
        return [np.asarray(a, np.float32) for a in _JAX[key](x, w, g)]


def port_upsample_conv(fused, dtype, x, w, g):
    block = blocks.UpBlock(CIN, COUT, fused, None if dtype == torch.float32 else dtype)
    with torch.no_grad():
        block[1].weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    y = block.upsample_conv(xt)
    y.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(y.dtype))
    assert y.dtype == dtype and y.shape == (N, COUT, 2 * H, 2 * W)
    return [y.detach().float().numpy().transpose(0, 2, 3, 1),
            xt.grad.numpy().transpose(0, 2, 3, 1),
            block[1].weight.grad.numpy().transpose(2, 3, 1, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fused", LOWERINGS)
def test_lowering_matches_jax(fused, dtype):
    x, w, g = _data(seed=LOWERINGS.index(fused))
    ours = port_upsample_conv(fused, dtype, x, w, g)
    ref = jax_upsample_conv(fused, dtype, x, w, g)
    rel_l2, rel_max = TOL[dtype]
    for what, a, r in zip(("y", "d x", "d w"), ours, ref):
        assert a.shape == r.shape, what
        scale = np.abs(r).max()
        assert np.linalg.norm(a - r) <= rel_l2 * np.linalg.norm(r), (fused, what)
        assert np.abs(a - r).max() <= rel_max * scale, (fused, what, np.abs(a - r).max() / scale)


def test_lowerings_compute_one_function():
    """In float32 the four lowerings give upsample-then-conv's output, each
    summing in its own order; at bfloat16 they agree within the rounding of
    their outputs."""
    x, w, g = _data(seed=9)
    for dtype in (torch.float32, torch.bfloat16):
        outs = {f: port_upsample_conv(f, dtype, x, w, g) for f in LOWERINGS}
        rel_l2, rel_max = TOL[dtype]
        for f in LOWERINGS[1:]:
            for a, r in zip(outs[f], outs["off"]):
                assert np.abs(a - r).max() <= rel_max * np.abs(r).max(), (f, dtype)


def test_parity_kernels_sum_the_taps():
    """Each parity kernel's taps are sums of 3x3 taps that together cover
    every tap once per parity class: their total is the 3x3 kernel's."""
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 3, 3, 3)))
    ks = fused_upsample.parity_kernels(w)
    assert set(ks) == {(0, 0), (0, 1), (1, 0), (1, 1)}
    for k in ks.values():
        assert k.shape == (4, 3, 2, 2)
        torch.testing.assert_close(k.sum(dim=(2, 3)), w.sum(dim=(2, 3)))
    torch.testing.assert_close(fused_upsample.composite_kernel(w).sum(dim=(2, 3)),
                               4 * w.sum(dim=(2, 3)))


def test_up_block_refuses_an_unknown_lowering():
    with pytest.raises(ValueError, match="FUSED_UPSAMPLE"):
        blocks.UpBlock(4, 2, "parity2")
