"""R(2+1)D-18, the FSD (Frechet Story Distance) feature extractor
(counterpart of `cpcsv_tpu/evaluation/r2plus1d.py:29-194`; reference
`fid/vfid_score.py:154-174`, `fid/residual2p1.py:9-50`): torchvision's
`r2plus1d_18` video ResNet, a stem of 45 then 64 channels and 4 stages of
2 (2+1)D basic blocks, averaged to 512 features.

The parameter names and NCTHW kernels are torchvision's, so a Kinetics
`r2plus1d_18` state_dict loads as it is, and the JAX package's
`load_torch_r2plus1d_state_dict` converts this module's.

The reference's wrapper computes a 112 x 112 resize and a [-1, 1] rescale
and then feeds the raw input to the network (`fid/residual2p1.py:36-49`),
so FSD features come from the [-1, 1] 64 x 64 stories as they are; the JAX
package's `fix_preprocessing` option, off by default and set by no caller,
is not ported.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cpcsv_tpu_torch.evaluation.weights import Extractor


def _midplanes(inplanes: int, planes: int) -> int:
    return (inplanes * planes * 3 * 3 * 3) // (inplanes * 3 * 3 + 3 * planes)


class Conv2Plus1D(nn.Sequential):
    """(1, 3, 3) spatial conv -> BN -> ReLU -> (3, 1, 1) temporal conv."""

    def __init__(self, inplanes: int, planes: int, midplanes: int, stride: int = 1):
        super().__init__(
            nn.Conv3d(inplanes, midplanes, (1, 3, 3), (1, stride, stride), (0, 1, 1), bias=False),
            nn.BatchNorm3d(midplanes),
            nn.ReLU(inplace=True),
            nn.Conv3d(midplanes, planes, (3, 1, 1), (stride, 1, 1), (1, 0, 0), bias=False),
        )


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Sequential(
            Conv2Plus1D(inplanes, planes, _midplanes(inplanes, planes), stride),
            nn.BatchNorm3d(planes), nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(
            Conv2Plus1D(planes, planes, _midplanes(planes, planes)), nn.BatchNorm3d(planes))
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv3d(inplanes, planes, 1, (stride, stride, stride), bias=False),
                nn.BatchNorm3d(planes))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu(self.conv2(self.conv1(x)) + residual)


class R2Plus1D18(nn.Module):
    """(N, 3, T, H, W) -> (N, 512) pooled features."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), bias=False),
            nn.BatchNorm3d(45), nn.ReLU(inplace=True),
            nn.Conv3d(45, 64, (3, 1, 1), (1, 1, 1), (1, 0, 0), bias=False),
            nn.BatchNorm3d(64), nn.ReLU(inplace=True))
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(inplanes, planes, stride), BasicBlock(planes, planes)))
            inplanes = planes

    def forward(self, x):
        x = self.stem(x)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3, 4))  # adaptive average pool -> (N, 512)


def make_fsd_extractor(weights_path: str | None = None,
                       device: str | torch.device = "cuda") -> Extractor:
    """stories (N, T, H, W, 3) -> (N, 512) features on `device`. The weights
    resolve through `evaluation.weights`; without a file the network runs
    from random init, warns, and is tagged `random_init=True`."""
    return Extractor(R2Plus1D18(), "r2plus1d_18", weights_path, device)
