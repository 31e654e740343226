"""Batched dynamic-filter 1-D convolution, the "Text2Gist" fusion op.

Counterpart of `cpcsv_tpu/ops/dynamic_filter.py`. Semantics (cross-correlation,
like torch F.conv1d, one filter bank per sample):

    out[b, o, x] = sum_{c,k} pad(image)[b, c, x + k] * filters[b, o, c, k]

A CUDA tensor always goes to the hand-written kernels (`ops/cuda/dfn.py`):
the forward kernel, and the backward kernel when autograd asks for the
gradients. They raise for what they do not take (O != 1, other dtypes). The
plain version below serves CPU tensors only; autograd differentiates it.

Both take float32 or bfloat16 (COMPUTE_DTYPE; the JAX package runs the op on
bfloat16 image and filters, `cpcsv_tpu/models/generator.py:_dfn_fuse`), sum
in float32 and round each output, and each gradient, to the input's dtype
once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda


def dynamic_filter_conv1d_plain(
    image: torch.Tensor, filters: torch.Tensor, pad: int
) -> torch.Tensor:
    """image (B, C, L), filters (B, O, C, K) -> (B, O, L + 2*pad - K + 1):
    pad, unfold the K taps, one einsum in float32 (or wider), the result in
    the input's dtype. Any O."""
    K = filters.shape[-1]
    acc = torch.promote_types(image.dtype, torch.float32)
    taps = F.pad(image.to(acc), (pad, pad)).unfold(2, K, 1)  # (B, C, L_out, K)
    return torch.einsum("bcxk,bock->box", taps, filters.to(acc)).to(image.dtype)


def dynamic_filter_conv1d_backward_plain(
    image: torch.Tensor, filters: torch.Tensor, dout: torch.Tensor, pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(d image, d filters) of the plain version for the output gradient
    `dout`, by autograd: the plain counterpart of the backward kernel."""
    with torch.enable_grad():
        image = image.detach().requires_grad_()
        filters = filters.detach().requires_grad_()
        out = dynamic_filter_conv1d_plain(image, filters, pad)
        return torch.autograd.grad(out, (image, filters), dout)


class _DynamicFilterKernel(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the CUDA backward kernel."""

    @staticmethod
    def forward(ctx, image, filters, pad):
        ctx.pad = pad
        ctx.save_for_backward(image, filters)
        return dfn_cuda.dfn_forward(image, filters, pad)

    @staticmethod
    def backward(ctx, dout):
        image, filters = ctx.saved_tensors
        # the kernel takes rows any distance apart (the G step hands it a
        # column slice of the gradient of a concatenation) but not a
        # strided or broadcast L_out
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dimage, dfilters = dfn_cuda.dfn_backward(image, filters, dout, ctx.pad)
        return dimage, dfilters, None


def dynamic_filter_conv1d(image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    if image.is_cuda:
        return _DynamicFilterKernel.apply(image, filters, pad)
    if image.device.type != "cpu":
        raise ValueError(f"dynamic_filter_conv1d runs on CUDA or the CPU, got {image.device}")
    return dynamic_filter_conv1d_plain(image, filters, pad)
