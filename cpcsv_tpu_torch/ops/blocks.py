"""Building blocks of the generator and the discriminators, NCHW.

Counterpart of `cpcsv_tpu/ops/blocks.py`. Module names and parameter shapes
follow the reference torch layout (`model.py:16-34`, `cascade_model.py:36-41`),
so a reference `netG_epoch_E.pth`, or a JAX checkpoint converted with
`utils/weights.py`, loads with ``load_state_dict(strict=True)``:

  UpBlock    = Sequential(Upsample, conv3x3, BN2d, ReLU)   -> "<name>.1.weight", "<name>.2.*"
  DownBlock  = Sequential(Conv2d(3, s2, bias), BN2d, ReLU) -> "<name>.0.*", "<name>.1.*"
  DenseBN    = Sequential(Linear, BN1d[, act])             -> "<name>.0.*", "<name>.1.*"

BatchNorm follows the module's mode. In eval mode it normalises with the
running statistics exactly as flax's `_normalize` does
(`cpcsv_tpu/ops/blocks.py:61-71, 87-102`). In train mode it normalises with
the batch statistics from the `bn_stats` kernel, differentiates through the
`bn_grad_reduce` kernel (`ops/batchnorm.py`), and updates the running
statistics in call order, as flax threads `batch_stats` through one apply.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.ops.batchnorm import batch_norm_train, update_running_stats
from cpcsv_tpu_torch.ops.fused_upsample import upsample2x_conv3x3

BN_EPS = 1e-5


class _BatchNorm:
    """Mixin for torch's BatchNorm classes: same parameters and buffers
    (weight, bias, running_mean, running_var, num_batches_tracked), forward
    in float32, in either mode:

        y = (x - mean) * (rsqrt(var + eps) * scale) + bias     (flax order)

    with the batch statistics in train mode (then the running statistics are
    updated, and num_batches_tracked counts up as in torch; it is inert at
    momentum 0.1), the running ones in eval mode.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps)
            update_running_stats(self.running_mean, self.running_var, mean, var,
                                 x.numel() // x.shape[1])
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


def Conv3x3(in_channels: int, out_channels: int) -> nn.Conv2d:
    """3x3 conv, stride 1, padding 1, no bias (reference `conv3x3`)."""
    return nn.Conv2d(in_channels, out_channels, 3, 1, 1, bias=False)


def Conv4x4s2(in_channels: int, out_channels: int) -> nn.Conv2d:
    """4x4 conv, stride 2, padding 1, no bias: halves H and W (the
    discriminators' first layer, reference `model.py:498`)."""
    return nn.Conv2d(in_channels, out_channels, 4, 2, 1, bias=False)


class UpBlock(nn.Sequential):
    """nearest-2x upsample -> conv3x3 -> BN -> ReLU (reference `upBlock`).

    `fused` is cfg.FUSED_UPSAMPLE: "off" upsamples then convolves; "deconv"
    computes the same function as one stride-2 transposed conv
    (`ops/fused_upsample.py`). The parameters are the same in both."""

    def __init__(self, in_channels: int, out_channels: int, fused: str = "off"):
        if fused not in ("off", "deconv"):
            raise NotImplementedError(
                f"FUSED_UPSAMPLE={fused!r}: the port has 'off' and 'deconv'; "
                "'parity4' and 'parity1' are not ported"
            )
        super().__init__(
            nn.Upsample(scale_factor=2, mode="nearest"),
            Conv3x3(in_channels, out_channels),
            BatchNorm2d(out_channels),
            nn.ReLU(),
        )
        self.fused = fused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused == "deconv":
            x = upsample2x_conv3x3(x, self[1].weight)
        else:
            x = self[1](self[0](x))
        return F.relu(self[2](x))


def DownBlock(in_channels: int, out_channels: int) -> nn.Sequential:
    """conv3x3 stride 2 with bias -> BN -> ReLU (reference `downBlock`)."""
    return nn.Sequential(
        nn.Conv2d(in_channels, out_channels, 3, 2, 1, bias=True),
        BatchNorm2d(out_channels),
        nn.ReLU(),
    )


def DenseBN(
    in_features: int,
    out_features: int,
    activation: nn.Module | None = None,
    bias: bool = True,
) -> nn.Sequential:
    """Linear -> BatchNorm1d [-> activation] (filter_net, image_net, fc,
    fc_seg, m_net, c_net; reference `model.py:250-308`)."""
    layers = [nn.Linear(in_features, out_features, bias=bias), BatchNorm1d(out_features)]
    if activation is not None:
        layers.append(activation)
    return nn.Sequential(*layers)
