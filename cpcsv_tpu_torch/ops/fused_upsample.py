"""Nearest-2x upsample + conv3x3 without the upsampled activation.

Counterpart of `cpcsv_tpu/ops/fused_upsample.py`, cfg.FUSED_UPSAMPLE's three
lowerings, each under the JAX package's name; "off" upsamples, then
convolves (`ops/blocks.py:UpBlock`):

  * "deconv" (`upsample2x_conv3x3_deconv`, the config default): a 3x3 conv
    of a nearest-2x-upsampled image equals an input-dilated conv with the
    4x4 composite kernel K[i, j] = sum_{a, b in {0, 1}} w[i - a, j - b]; an
    input-dilated conv with padding 2 is a stride-2 transposed conv with
    padding 1 and the spatially flipped kernel;
  * "parity4" (`upsample2x_conv3x3`): each output parity class (y % 2,
    x % 2) is a 2x2 conv of the original grid with sums of the 3x3 taps
    (`parity_kernels`); four convs, then an interleave;
  * "parity1" (`upsample2x_conv3x3_oneconv`): the four parity kernels
    stacked along the output channels, one 2x2 conv of the input padded by
    1 on every side, then a slice and an interleave.

All three are 2.25x fewer MACs than upsampling first. Activations are NCHW
and the weight is the conv's (Cout, Cin, 3, 3). The kernels are summed from
the weight as it is passed in, in the JAX package's order: at bfloat16 the
caller passes the cast weight, so the sums round as the JAX package's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def composite_kernel(w: torch.Tensor) -> torch.Tensor:
    """conv weight (Cout, Cin, 3, 3) -> composite (Cout, Cin, 4, 4)."""
    wp = F.pad(w, (0, 1, 0, 1))  # the padded row/col is zero, so rolls are safe
    return wp + wp.roll(1, 2) + wp.roll(1, 3) + wp.roll((1, 1), (2, 3))


def upsample2x_conv3x3_deconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, Cin, H, W), w (Cout, Cin, 3, 3) -> (N, Cout, 2H, 2W); equal,
    up to summation order, to conv2d(interpolate(x, 2, nearest), w, pad=1)."""
    k4 = composite_kernel(w)
    # conv_transpose2d takes (Cin, Cout, kH, kW) and correlates with the
    # flipped kernel, so flip to get correlation with k4
    return F.conv_transpose2d(x, k4.flip(2, 3).transpose(0, 1), stride=2, padding=1)


def parity_kernels(w: torch.Tensor) -> dict:
    """w (Cout, Cin, 3, 3) -> {(py, px): (Cout, Cin, 2, 2)}. Output row 2h+py
    reads source rows [h-1, h] with row kernel [w0, w1+w2] (py = 0) or rows
    [h, h+1] with [w0+w1, w2] (py = 1); columns alike."""
    r0 = torch.stack([w[:, :, 0], w[:, :, 1] + w[:, :, 2]], dim=2)  # (Cout, Cin, 2, 3)
    r1 = torch.stack([w[:, :, 0] + w[:, :, 1], w[:, :, 2]], dim=2)
    out = {}
    for py, r in ((0, r0), (1, r1)):
        out[py, 0] = torch.stack([r[..., 0], r[..., 1] + r[..., 2]], dim=3)
        out[py, 1] = torch.stack([r[..., 0] + r[..., 1], r[..., 2]], dim=3)
    return out


def _interleave(parts: dict) -> torch.Tensor:
    """{(py, px): (N, C, H, W)} -> (N, C, 2H, 2W), out[2h+py, 2w+px] = parts[py, px][h, w]."""
    row0 = torch.stack([parts[0, 0], parts[0, 1]], dim=-1)  # (N, C, H, W, 2)
    row1 = torch.stack([parts[1, 0], parts[1, 1]], dim=-1)
    N, C, H, W, _ = row0.shape
    return torch.stack([row0, row1], dim=3).reshape(N, C, 2 * H, 2 * W)


def upsample2x_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"parity4": four 2x2 convs, one a parity class, then an interleave.
    Parity 0 reads the previous source row (column): padding 1 before, 0
    after; parity 1 the next: 0 before, 1 after."""
    ks = parity_kernels(w)
    # F.pad's order: (left, right, top, bottom)
    pads = {(0, 0): (1, 0, 1, 0), (0, 1): (0, 1, 1, 0), (1, 0): (1, 0, 0, 1), (1, 1): (0, 1, 0, 1)}
    return _interleave({q: F.conv2d(F.pad(x, pads[q]), ks[q]) for q in pads})


def upsample2x_conv3x3_oneconv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """"parity1": the four parity kernels as 4·Cout output channels of one
    2x2 conv over x padded by 1 -> (N, 4·Cout, H+1, W+1); parity (py, px)
    is the [py:py+H, px:px+W] window of its Cout channels."""
    ks = parity_kernels(w)
    order = ((0, 0), (0, 1), (1, 0), (1, 1))
    z = F.conv2d(x, torch.cat([ks[q] for q in order], dim=0), padding=1)
    Cout, H, W = w.shape[0], x.shape[2], x.shape[3]
    return _interleave({(py, px): z[:, i * Cout:(i + 1) * Cout, py:py + H, px:px + W]
                        for i, (py, px) in enumerate(order)})


# cfg.FUSED_UPSAMPLE -> its lowering ("off" is UpBlock's own upsample and conv)
LOWERINGS = {
    "parity4": upsample2x_conv3x3,
    "parity1": upsample2x_conv3x3_oneconv,
    "deconv": upsample2x_conv3x3_deconv,
}
