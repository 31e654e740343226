"""Frechet distance between two Gaussians of features (counterpart of
`cpcsv_tpu/evaluation/frechet.py`; reference `fid/fid_score.py:107-158`,
itself the pytorch-fid formula):

    d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrt(C1 C2))

If the matrix square root is not finite, it is taken again with eps * I
added to both covariances; a significant imaginary part raises. numpy and
scipy on the host, in float64: a walk pays one `sqrtm` of D x D (D = 2048
for FID, 512 for FSD) a distance.
"""

from __future__ import annotations

import numpy as np
from scipy import linalg


def calculate_activation_statistics(act: np.ndarray):
    """act (N, D) -> (mu (D,), sigma (D, D)), float64 (reference
    fid_score.py:96-104)."""
    act = np.asarray(act, dtype=np.float64)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    mu1 = np.atleast_1d(np.asarray(mu1, dtype=np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, dtype=np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, dtype=np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, dtype=np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"statistics of different widths: mu {mu1.shape} vs {mu2.shape}, "
                         f"sigma {sigma1.shape} vs {sigma2.shape}")

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))

    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))
