"""Spectral normalization (counterpart of `cpcsv_tpu/ops/spectral_norm.py`).

The JAX package's `SNConv` reproduces `torch.nn.utils.spectral_norm`, which
the reference wraps its discriminator convolutions in, so the port uses that
function itself. With W_mat = weight_orig.view(out, -1), each forward in
train mode runs one power iteration on the stored u:

    v = normalize(W_matᵀ u);  u' = normalize(W_mat v);  σ = u'ᵀ (W_mat v)
    weight = weight_orig / σ

u and v are buffers, updated in place on every call in call order, while σ
is computed from the live weight, so the gradient carries the −(W/σ²)·u vᵀ
term as in JAX. eps is 1e-12 on both sides (torch divides by
max(‖x‖, eps), JAX by ‖x‖ + eps). The state is `weight_orig`, `weight_u`
and `weight_v`, the names `cpcsv_tpu/utils/export_torch.py` writes.
"""

from __future__ import annotations

import torch.nn as nn
from torch.nn.utils import spectral_norm

SN_EPS = 1e-12


def SNConv2d(in_channels: int, out_channels: int, kernel_size: int, stride: int,
             padding: int, bias: bool = False) -> nn.Conv2d:
    """A spectral-normalized nn.Conv2d, one power iteration per train forward."""
    conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding, bias=bias)
    return spectral_norm(conv, n_power_iterations=1, eps=SN_EPS)
