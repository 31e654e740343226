"""Batched features over host datasets (counterpart of
`cpcsv_tpu/evaluation/features.py`; reference fid/fid_score.py:57-104,
fid/vfid_score.py:50-97): fixed batches with drop_last, as the reference
(the trailing items are left out), through an extractor callable (numpy
batch in, numpy features out: `weights.Extractor`)."""

from __future__ import annotations

from typing import Callable

import numpy as np

from cpcsv_tpu_torch.evaluation.frechet import calculate_activation_statistics


def iter_batches(dataset, batch_size: int):
    """Whole batches of the dataset's items, stacked; the tail is left out."""
    for b in range(len(dataset) // batch_size):
        yield np.stack([dataset[i] for i in range(b * batch_size, (b + 1) * batch_size)])


def extract_activations(dataset, extractor: Callable, batch_size: int,
                        normalize: bool = False) -> np.ndarray:
    """dataset[i] -> an image (H, W, C) or a story (T, H, W, C), float;
    `normalize` shifts [-1, 1] to [0, 1] (the reference's normalize=True)."""
    feats = []
    for batch in iter_batches(dataset, batch_size):
        x = batch.astype(np.float32)
        if normalize:
            x = (x + 1.0) / 2.0
        feats.append(np.asarray(extractor(x)))
    if not feats:
        raise ValueError("dataset smaller than one batch")
    return np.concatenate(feats, axis=0)


def activation_statistics(dataset, extractor, batch_size: int, normalize: bool = False):
    """(mu, sigma) of the dataset's features."""
    return calculate_activation_statistics(
        extract_activations(dataset, extractor, batch_size, normalize))
