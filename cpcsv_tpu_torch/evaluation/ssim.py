"""SSIM (counterpart of `cpcsv_tpu/evaluation/ssim.py`; reference
`ssim_score.py` and the pytorch-ssim package it imports): an 11 x 11
Gaussian window (sigma 1.5) applied per channel as a depthwise `F.conv2d`
with padding 5, C1 = 0.01^2, C2 = 0.03^2, the mean of the SSIM map. On the
tensors' device, in float32."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cpcsv_tpu_torch.device import float32_math


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@torch.no_grad()
def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """img1, img2 (N, H, W, C), any common range (the reference feeds [-1, 1]
    frames) -> the scalar mean SSIM."""
    x, y = img1.permute(0, 3, 1, 2).float(), img2.permute(0, 3, 1, 2).float()
    C = x.shape[1]
    w = torch.from_numpy(_gaussian_window(window_size)).to(x.device)
    w = w.expand(C, 1, window_size, window_size)

    def filt(t):
        return F.conv2d(t, w, padding=window_size // 2, groups=C)

    with float32_math():
        mu1, mu2 = filt(x), filt(y)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = filt(x * x) - mu1_sq
        sigma2_sq = filt(y * y) - mu2_sq
        sigma12 = filt(x * y) - mu1_mu2
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return ssim_map.mean()


def ssim_score(pairs_iter, device: str | torch.device = "cpu") -> float:
    """The mean SSIM over (fake, real) pairs of (N, H, W, C) numpy arrays,
    each pair weighted by its N (reference ssim_score.py:13-28)."""
    vals, n = 0.0, 0
    for fake, real in pairs_iter:
        vals += float(ssim(torch.as_tensor(fake, device=device),
                           torch.as_tensor(real, device=device))) * len(fake)
        n += len(fake)
    return vals / max(n, 1)
