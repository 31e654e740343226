"""Nearest-2x upsample + conv3x3 as one transposed convolution.

Counterpart of `cpcsv_tpu/ops/fused_upsample.py:upsample2x_conv3x3_deconv`
(cfg.FUSED_UPSAMPLE="deconv", the config default). A 3x3 conv of a
nearest-2x-upsampled image equals an input-dilated conv with the 4x4
composite kernel K[i, j] = sum_{a, b in {0, 1}} w[i - a, j - b]; an
input-dilated conv with padding 2 is a stride-2 transposed conv with
padding 1 and the spatially flipped kernel. 2.25x fewer MACs than
upsampling first, and the 2x activation is never written.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def composite_kernel(w: torch.Tensor) -> torch.Tensor:
    """conv weight (Cout, Cin, 3, 3) -> composite (Cout, Cin, 4, 4)."""
    wp = F.pad(w, (0, 1, 0, 1))  # the padded row/col is zero, so rolls are safe
    return wp + wp.roll(1, 2) + wp.roll(1, 3) + wp.roll((1, 1), (2, 3))


def upsample2x_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, Cin, H, W), w (Cout, Cin, 3, 3) -> (N, Cout, 2H, 2W); equal,
    up to summation order, to conv2d(interpolate(x, 2, nearest), w, pad=1)."""
    k4 = composite_kernel(w)
    # conv_transpose2d takes (Cin, Cout, kH, kW) and correlates with the
    # flipped kernel, so flip to get correlation with k4
    return F.conv_transpose2d(x, k4.flip(2, 3).transpose(0, 1), stride=2, padding=1)
