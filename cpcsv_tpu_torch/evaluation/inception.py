"""InceptionV3 for FID, the pool3 feature extractor (counterpart of
`cpcsv_tpu/evaluation/inception.py:30-205`; reference `fid/inception.py`, the
pytorch-fid network with the `pt_inception-2015-12-05` weights):

  * BasicConv2d = conv without bias + BN (eps 1e-3) + ReLU;
  * the FID blocks: InceptionA, C and E average-pool with
    count_include_pad=False, and the last E block (Mixed_7c) max-pools;
  * input (N, 3, H, W) in [0, 1], resized to 299 x 299 bilinearly
    (align_corners=False, as `jax.image.resize` when upsampling) and
    scaled to [-1, 1]; output (N, 2048).

The parameter names and NCHW kernels are torchvision's, so a pytorch-fid
state_dict loads as it is, and the JAX package's
`load_torch_inception_state_dict` converts this module's.
`make_inception_extractor` returns the metric's callable.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.evaluation.weights import Extractor


def _avg_pool_3x3_exclude_pad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x: torch.Tensor, stride: int, padding: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=padding)


class BasicConv2d(nn.Module):
    def __init__(self, inp: int, out: int, **conv):
        super().__init__()
        self.conv = nn.Conv2d(inp, out, bias=False, **conv)
        self.bn = nn.BatchNorm2d(out, eps=1e-3)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class InceptionA(nn.Module):
    def __init__(self, inp: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(inp, 64, kernel_size=1)
        self.branch5x5_1 = BasicConv2d(inp, 48, kernel_size=1)
        self.branch5x5_2 = BasicConv2d(48, 64, kernel_size=5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(inp, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, padding=1)
        self.branch_pool = BasicConv2d(inp, pool_features, kernel_size=1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b5, bd, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, inp: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(inp, 384, kernel_size=3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(inp, 64, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, kernel_size=3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, kernel_size=3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, inp: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(inp, 192, kernel_size=1)
        self.branch7x7_1 = BasicConv2d(inp, c7, kernel_size=1)
        self.branch7x7_2 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(inp, c7, kernel_size=1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(inp, 192, kernel_size=1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_exclude_pad(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, inp: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(inp, 192, kernel_size=1)
        self.branch3x3_2 = BasicConv2d(192, 320, kernel_size=3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(inp, 192, kernel_size=1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, kernel_size=(1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, kernel_size=(7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, kernel_size=3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, inp: int, use_max_pool: bool = False):
        super().__init__()
        self.use_max_pool = use_max_pool  # FID: the last block max-pools
        self.branch1x1 = BasicConv2d(inp, 320, kernel_size=1)
        self.branch3x3_1 = BasicConv2d(inp, 384, kernel_size=1)
        self.branch3x3_2a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(inp, 448, kernel_size=1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, kernel_size=3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, kernel_size=(1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, kernel_size=(3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(inp, 192, kernel_size=1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = _max_pool(x, 1, 1) if self.use_max_pool else _avg_pool_3x3_exclude_pad(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class InceptionV3FID(nn.Module):
    """(N, 3, H, W) in [0, 1] -> (N, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, kernel_size=3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, kernel_size=3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, kernel_size=3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, kernel_size=1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, kernel_size=3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, use_max_pool=False)
        self.Mixed_7c = InceptionE(2048, use_max_pool=True)

    def forward(self, x):
        x = F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x, 2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> (N, 2048)


def make_inception_extractor(weights_path: str | None = None,
                             device: str | torch.device = "cuda") -> Extractor:
    """images (N, H, W, 3) in [0, 1] -> (N, 2048) features on `device`. The
    weights resolve through `evaluation.weights`; without a file the network
    runs from random init, warns, and is tagged `random_init=True`."""
    return Extractor(InceptionV3FID(), "inception_fid", weights_path, device)
