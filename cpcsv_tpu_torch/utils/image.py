"""Image save helpers (counterpart of `cpcsv_tpu/utils/image.py`; reference
`miscc/utils.py:230-311`): numpy and PIL, HWC frames in [-1, 1]."""

from __future__ import annotations

import numpy as np


def images_to_numpy(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float HWC -> uint8 (reference miscc/utils.py:230-235)."""
    img = np.clip(img, -1, 1)
    return ((img + 1) / 2 * 255).astype("uint8")


def make_grid(images: np.ndarray, ncol: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) float [-1, 1] -> grid (H', W', C), as
    torchvision.utils.make_grid(padding=2, pad_value=0) lays it out."""
    n, h, w, c = images.shape
    ncol = min(ncol, n)
    nrow = (n + ncol - 1) // ncol
    grid = np.full((nrow * (h + pad) + pad, ncol * (w + pad) + pad, c), 0.0, images.dtype)
    for i in range(n):
        r, cl = divmod(i, ncol)
        y, x = pad + r * (h + pad), pad + cl * (w + pad)
        grid[y : y + h, x : x + w] = images[i]
    return grid


def save_png(img_float_hwc: np.ndarray, path: str) -> None:
    from PIL import Image

    arr = images_to_numpy(img_float_hwc)
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path)
