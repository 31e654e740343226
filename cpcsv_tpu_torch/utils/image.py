"""Image save helpers (counterpart of `cpcsv_tpu/utils/image.py`; reference
`miscc/utils.py:230-311`): numpy and PIL, HWC frames in [-1, 1], grids laid
out as torchvision's make_grid does."""

from __future__ import annotations

import os

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


def _story_rows(videos: np.ndarray, ncol: int) -> np.ndarray:
    """uint8 grid of (B, T, H, W, C) frames in [-1, 1], a row a story."""
    return images_to_numpy(make_grid(np.stack([make_grid(v, ncol) for v in videos]), 1))


def save_story_results(
    ground_truth: np.ndarray | None, videos: np.ndarray, texts, name, image_dir: str
) -> np.ndarray:
    """The epoch sample grid (reference save_story_results,
    miscc/utils.py:237-280): a row of T frames per story, the real stories
    beside the generated ones, as uint8; the stories' texts go to
    `image_dir`/fake_samples_{name}.txt. videos (B, T, H, W, C) in [-1, 1]."""
    T = videos.shape[1]
    all_images = _story_rows(videos, T)
    if ground_truth is not None:
        all_images = np.concatenate([all_images, _story_rows(ground_truth, T)], axis=1)
    if texts is not None:
        # texts: per story, a list of per-frame strings or one string
        with open(os.path.join(image_dir, f"fake_samples_{name}.txt"), "w") as fid:
            for idx in range(min(videos.shape[0], len(texts))):
                fid.write(f"{idx} {'-' * 40}\n")
                item = texts[idx]
                for line in item if isinstance(item, (list, tuple)) else [item]:
                    fid.write(str(line) + "\n")
                fid.write("\n\n")
    return all_images


def save_image_results(
    ground_truth: np.ndarray | None, images: np.ndarray, video_len: int = 5
) -> np.ndarray:
    """The segment grid (reference save_image_results, miscc/utils.py:282-301):
    images (B*T, H, W, C) in [-1, 1], a row of `video_len` a story, as uint8."""
    stories = lambda x: x.reshape(-1, video_len, *x.shape[1:])  # noqa: E731
    all_images = _story_rows(stories(images), video_len)
    if ground_truth is not None:
        all_images = np.concatenate(
            [all_images, _story_rows(stories(ground_truth), video_len)], axis=1)
    return all_images


def save_png(img_float_hwc: np.ndarray, path: str) -> None:
    from PIL import Image

    arr = images_to_numpy(img_float_hwc)
    if arr.shape[-1] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path)


def save_all_img(videos: np.ndarray, count: int, image_dir: str) -> int:
    """Every frame of (B, T, H, W, C) videos in [-1, 1] as {count}.png,
    counting on from `count`; returns the last number written (reference
    save_all_img, miscc/utils.py:303-311, the numbered-PNG protocol)."""
    os.makedirs(image_dir, exist_ok=True)
    for b in range(videos.shape[0]):
        for t in range(videos.shape[1]):
            count += 1
            save_png(videos[b, t], os.path.join(image_dir, f"{count}.png"))
    return count
