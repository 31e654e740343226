"""Host-side image transforms (counterpart of `cpcsv_tpu/data/transforms.py`;
reference main_pororo.py:71-95): PIL bilinear resize, as
torchvision.transforms.Resize, and Normalize(0.5, 0.5) to [-1, 1].

Outputs are float32 HWC frames and (T, H, W, C) videos: the datasets'
item layout, the same bits as the JAX package's. The train steps move them
to NCHW on the device.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def resize_image(arr: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC (or HW) -> uint8 size x size, PIL bilinear."""
    if arr.shape[0] == size and arr.shape[1] == size:
        return arr
    return np.asarray(Image.fromarray(arr).resize((size, size), Image.BILINEAR))


def normalize_image(arr: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC (or HW) -> float32 (size, size, C) in [-1, 1]."""
    arr = resize_image(arr, size)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr.astype(np.float32) / 127.5 - 1.0


def video_transform(frames: np.ndarray, size: int) -> np.ndarray:
    """(T, H, W, C) uint8 -> (T, size, size, C) float32 in [-1, 1]
    (reference datasets/utils.py:3-10, T-major instead of C, T, H, W)."""
    return np.stack([normalize_image(f, size) for f in frames], axis=0)
