"""Deterministic synthetic stories with the Pororo batch schema (counterpart
of `cpcsv_tpu/data/synthetic.py`: the same items from the same seed), and a
plain batching iterator for them."""

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
