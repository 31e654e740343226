"""Building blocks of the generator and the discriminators, NCHW.

Counterpart of `cpcsv_tpu/ops/blocks.py`. Module names and parameter shapes
follow the reference torch layout (`model.py:16-34`, `cascade_model.py:36-41`),
so a reference `netG_epoch_E.pth`, or a JAX checkpoint converted with
`utils/weights.py`, loads with ``load_state_dict(strict=True)``:

  UpBlock    = Sequential(Upsample, conv3x3, BN2d, ReLU)   -> "<name>.1.weight", "<name>.2.*"
  DownBlock  = Sequential(Conv2d(3, s2, bias), BN2d, ReLU) -> "<name>.0.*", "<name>.1.*"
  DenseBN    = Sequential(Linear, BN1d[, act])             -> "<name>.0.*", "<name>.1.*"

Compute dtype (cfg.COMPUTE_DTYPE), as the JAX package threads `dtype=`: the
parameters stay float32; `Conv2d` and `Linear` cast their input, weight and
bias to `dtype` and yield `dtype`, and so does `Conv3d`, the order-consistency
VideoEncoder's. `dtype=None` (float32) casts nothing, so the layers run in
the parameters' own dtype.

BatchNorm follows the module's mode and yields its input's dtype. In eval
mode it normalises with the running statistics exactly as flax's
`_normalize` does (`cpcsv_tpu/ops/blocks.py:61-71, 87-102`), in float32. In
train mode it normalises with the batch statistics from the `bn_stats`
kernel, differentiates through the `bn_grad_reduce` kernel
(`ops/batchnorm.py`), and updates the running statistics in call order, as
flax threads `batch_stats` through one apply.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.ops.batchnorm import (
    batch_norm_train,
    global_rows,
    is_recomputing,
    update_running_stats,
)
from cpcsv_tpu_torch.ops.fused_upsample import LOWERINGS

BN_EPS = 1e-5
FUSED_UPSAMPLE = ("off",) + tuple(LOWERINGS)  # cfg.FUSED_UPSAMPLE's values


def cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    """t in the compute dtype; None (float32) leaves it as it is."""
    return t if t is None or dtype is None else t.to(dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d at a compute dtype (`cpcsv_tpu/ops/blocks.py:276-277`)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt), cast(self.bias, dt))


class Conv3d(nn.Conv3d):
    """nn.Conv3d at a compute dtype (the VideoEncoder's `SNConv`,
    `cpcsv_tpu/ops/spectral_norm.py:114-121`)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt), cast(self.bias, dt))


class Linear(nn.Linear):
    """nn.Linear at a compute dtype (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, *args, dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt), cast(self.bias, dt))


class _BatchNorm:
    """Mixin for torch's BatchNorm classes: same parameters and buffers
    (weight, bias, running_mean, running_var, num_batches_tracked), forward
    in float32 in either mode, the output in the input's dtype:

        y = (x - mean) * (rsqrt(var + eps) * scale) + bias     (flax order)

    with the batch statistics in train mode (then the running statistics are
    updated, and num_batches_tracked counts up as in torch; it is inert at
    momentum 0.1; REMAT's recompute updates neither), the running ones in
    eval mode.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
            if not is_recomputing():
                update_running_stats(self.running_mean, self.running_var, mean, var,
                                     global_rows(x))
                self.num_batches_tracked.add_(1)
            return y
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = self.running_mean.float().view(shape)
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        y = (x.float() - mean) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class BatchNorm1d(_BatchNorm, nn.BatchNorm1d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)


class BatchNorm2d(_BatchNorm, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)


class BatchNorm3d(_BatchNorm, nn.BatchNorm3d):
    """(N, C, T, H, W): the kernels reduce it as (N, C, T·H·W)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)


def Conv3x3(in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None) -> Conv2d:
    """3x3 conv, stride 1, padding 1, no bias (reference `conv3x3`)."""
    return Conv2d(in_channels, out_channels, 3, 1, 1, bias=False, dtype=dtype)


def Conv4x4s2(in_channels: int, out_channels: int, dtype: Optional[torch.dtype] = None) -> Conv2d:
    """4x4 conv, stride 2, padding 1, no bias: halves H and W (the
    discriminators' first layer, reference `model.py:498`)."""
    return Conv2d(in_channels, out_channels, 4, 2, 1, bias=False, dtype=dtype)


class UpBlock(nn.Sequential):
    """nearest-2x upsample -> conv3x3 -> BN -> ReLU (reference `upBlock`).

    `fused` is cfg.FUSED_UPSAMPLE: "off" upsamples then convolves; "deconv",
    "parity4" and "parity1" compute the same function without the 2x
    activation (`ops/fused_upsample.py`). The parameters are the same in all
    four, so the lowering may change between calls."""

    def __init__(self, in_channels: int, out_channels: int, fused: str = "off",
                 dtype: Optional[torch.dtype] = None):
        if fused not in FUSED_UPSAMPLE:
            raise ValueError(f"FUSED_UPSAMPLE={fused!r} invalid; one of {FUSED_UPSAMPLE}")
        super().__init__(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv3x3(in_channels, out_channels, dtype),
            BatchNorm2d(out_channels),
            nn.ReLU(),
        )
        self.fused = fused

    def upsample_conv(self, x: torch.Tensor) -> torch.Tensor:
        """conv3x3(nearest_upsample_2x(x)) by the block's lowering, in the
        conv's compute dtype: the kernels are summed from the cast weight."""
        conv = self[1]
        if self.fused == "off":
            return conv(self[0](x))
        dt = conv.compute_dtype
        return LOWERINGS[self.fused](cast(x, dt), cast(conv.weight, dt))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self[2](self.upsample_conv(x)))


def DownBlock(in_channels: int, out_channels: int,
              dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """conv3x3 stride 2 with bias -> BN -> ReLU (reference `downBlock`)."""
    return nn.Sequential(
        Conv2d(in_channels, out_channels, 3, 2, 1, bias=True, dtype=dtype),
        BatchNorm2d(out_channels),
        nn.ReLU(),
    )


def DenseBN(
    in_features: int,
    out_features: int,
    activation: nn.Module | None = None,
    bias: bool = True,
    dtype: Optional[torch.dtype] = None,
) -> nn.Sequential:
    """Linear -> BatchNorm1d [-> activation] (filter_net, image_net, fc,
    fc_seg, m_net, c_net; reference `model.py:250-308`)."""
    layers = [Linear(in_features, out_features, bias=bias, dtype=dtype),
              BatchNorm1d(out_features)]
    if activation is not None:
        layers.append(activation)
    return nn.Sequential(*layers)
