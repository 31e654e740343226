"""Deterministic synthetic stories and images with the Pororo item schema
(counterpart of `cpcsv_tpu/data/synthetic.py`: the same items from the same
seed), a plain batching iterator for stories, and the train step's synthetic
batches (`synthetic_batches`, counterpart of
`cpcsv_tpu/utils/benchutil.py:100-123`)."""

from __future__ import annotations

from typing import Iterator

import numpy as np


class SyntheticStoryDataset:
    def __init__(
        self,
        n: int = 64,
        video_len: int = 5,
        imsize: int = 64,
        text_dim: int = 356,
        label_num: int = 9,
        seed: int = 0,
    ):
        self.n = n
        self.video_len = video_len
        self.imsize = imsize
        self.text_dim = text_dim
        self.label_num = label_num
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, item: int) -> dict:
        rng = np.random.default_rng(self.seed * 1_000_003 + item)
        T, S = self.video_len, self.imsize
        images = rng.uniform(-1, 1, (T, S, S, 3)).astype(np.float32)
        des = rng.standard_normal((T, self.text_dim)).astype(np.float32)
        labels = (rng.random((T, self.label_num)) < 0.3).astype(np.float32)
        return {
            "images": images,
            "description": des,
            "subtitle": des[:, :128].copy(),
            "labels": labels,
            "text": [f"synthetic story {item} frame {t}" for t in range(T)],
        }


class SyntheticImageDataset:
    """Single frames with their story's content (reference ImageDataset,
    datasets/pororo.py:181-246): images (64, 64, 3), description (356),
    subtitle (128), labels (9), content (T, 365) and, with `use_segment`,
    images_seg (64, 64, 1), all float32, and a text string."""

    def __init__(
        self,
        n: int = 64,
        video_len: int = 5,
        imsize: int = 64,
        sesize: int = 64,
        text_dim: int = 356,
        label_num: int = 9,
        use_segment: bool = True,
        seed: int = 1,
    ):
        self.n = n
        self.video_len = video_len
        self.imsize = imsize
        self.sesize = sesize
        self.text_dim = text_dim
        self.label_num = label_num
        self.use_segment = use_segment
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, item: int) -> dict:
        rng = np.random.default_rng(self.seed * 7_000_003 + item)
        S = self.imsize
        out = {
            "images": rng.uniform(-1, 1, (S, S, 3)).astype(np.float32),
            "description": rng.standard_normal(self.text_dim).astype(np.float32),
            "subtitle": rng.standard_normal(128).astype(np.float32),
            "labels": (rng.random(self.label_num) < 0.3).astype(np.float32),
            "content": rng.standard_normal(
                (self.video_len, self.text_dim + self.label_num)).astype(np.float32),
            "text": f"synthetic image {item}",
        }
        if self.use_segment:
            out["images_seg"] = rng.uniform(
                -1, 1, (self.sesize, self.sesize, 1)).astype(np.float32)
        return out


def story_batches(dataset, batch_size: int) -> Iterator[dict]:
    """Consecutive batches in dataset order; arrays are stacked, other
    fields listed. The last batch may be short."""
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        yield {
            key: np.stack([it[key] for it in items]) if isinstance(items[0][key], np.ndarray)
            else [it[key] for it in items]
            for key in items[0]
        }


def synthetic_batches(cfg, b_st: int, b_im: int, seed: int = 0) -> tuple[dict, dict]:
    """(st_batch, im_batch) numpy float32 dicts in the train step's schema,
    the same values as the JAX package's from the same seed (without the
    order-consistency fields), at the config's VIDEO_LEN, TEXT.DIMENSION and
    LABEL_NUM: the JAX package's fixed 356 and 9 at Pororo's, CLEVR's 18 and
    8 at `clevr.yml`'s."""
    T, D, L = cfg.VIDEO_LEN, cfg.TEXT.DIMENSION, cfg.LABEL_NUM
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def labels(*shape):
        return (rng.random(shape) < 0.3).astype(np.float32)

    st_batch = {"images": normal(b_st, T, 64, 64, 3), "description": normal(b_st, T, D),
                "labels": labels(b_st, T, L)}
    im_batch = {"images": normal(b_im, 64, 64, 3), "description": normal(b_im, D),
                "labels": labels(b_im, L), "content": normal(b_im, T, D)}
    if cfg.SEGMENT_LEARNING:
        im_batch["images_seg"] = normal(b_im, 64, 64, 1)
    return st_batch, im_batch
