"""Spectral normalization (counterpart of `cpcsv_tpu/ops/spectral_norm.py`).

The JAX package's `SNConv` and `SNDense` reproduce
`torch.nn.utils.spectral_norm`, which the reference wraps its discriminator
convolutions and the VideoEncoder's layers in, so the port uses that
function itself. With W_mat = weight_orig.view(out, -1), each forward in
train mode runs one power iteration on the stored u:

    v = normalize(W_matᵀ u);  u' = normalize(W_mat v);  σ = u'ᵀ (W_mat v)
    weight = weight_orig / σ

u and v are buffers, updated in place on every call in call order, while σ
is computed from the live weight, so the gradient carries the −(W/σ²)·u vᵀ
term as in JAX. eps is 1e-12 on both sides (torch divides by
max(‖x‖, eps), JAX by ‖x‖ + eps). The state is `weight_orig`, `weight_u`
and `weight_v`, the names `cpcsv_tpu/utils/export_torch.py` writes. A conv
kernel flattens to (out, in·k…) here and to (out, k…·in) in JAX: the
columns differ by a permutation, which leaves σ and u as they are. A dense
layer's W_mat is (out, in) on both sides.

At a compute dtype (`cpcsv_tpu/ops/spectral_norm.py:114-121`) σ, the power
iteration and weight_orig / σ stay in the parameters' float32; the layer
casts that weight, its input and its bias to `dtype` (`blocks.Conv2d`,
`blocks.Conv3d`, `blocks.Linear`).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn.utils import spectral_norm

from cpcsv_tpu_torch.ops.blocks import Conv2d, Conv3d, Linear

SN_EPS = 1e-12


def _sn(layer):
    return spectral_norm(layer, n_power_iterations=1, eps=SN_EPS)


def SNConv2d(in_channels: int, out_channels: int, kernel_size: int, stride: int,
             padding: int, bias: bool = False, dtype: Optional[torch.dtype] = None) -> Conv2d:
    """A spectral-normalized conv at a compute dtype, one power iteration per
    train forward."""
    return _sn(Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=bias,
                      dtype=dtype))


def SNConv3d(in_channels: int, out_channels: int, kernel_size, stride, padding,
             bias: bool = False, dtype: Optional[torch.dtype] = None) -> Conv3d:
    """The 3-D counterpart (JAX `SNConv` on NDHWC), (t, h, w) tuples."""
    return _sn(Conv3d(in_channels, out_channels, kernel_size, stride, padding, bias=bias,
                      dtype=dtype))


def SNLinear(in_features: int, out_features: int, bias: bool = True,
             dtype: Optional[torch.dtype] = None) -> Linear:
    """A spectral-normalized dense layer (JAX `SNDense`)."""
    return _sn(Linear(in_features, out_features, bias=bias, dtype=dtype))
