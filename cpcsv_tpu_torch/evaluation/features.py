"""Batched features over host datasets (counterpart of
`cpcsv_tpu/evaluation/features.py`; reference fid/fid_score.py:57-104,
fid/vfid_score.py:50-97): fixed batches with drop_last, as the reference
(the trailing items are left out), through an extractor callable (numpy
batch in, numpy features out: `weights.Extractor`)."""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from cpcsv_tpu_torch.evaluation.frechet import calculate_activation_statistics


def iter_batches(dataset, batch_size: int, drop_last: bool = True):
    """The dataset's items in batches, stacked; with `drop_last` the tail
    that fills no whole batch is left out, else it is the last batch."""
    n = len(dataset)
    batches = n // batch_size if drop_last else -(-n // batch_size)
    for b in range(batches):
        yield np.stack([dataset[i] for i in range(b * batch_size, min((b + 1) * batch_size, n))])


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


def activation_statistics(dataset, extractor, batch_size: int, normalize: bool = False,
                          cache: str | None = None):
    """(mu, sigma) of the dataset's features. With `cache` (a path, the
    reference's real-side .npz, fid/vfid_score.py:157-167) they are read
    from, or else written to, `<cache less .npz>.<fingerprint>.npz`, keyed
    by the extractor's `fingerprint` and holding it: statistics of one set of
    weights are never read for another. An extractor without a fingerprint
    reads only what one without a fingerprint wrote ('unkeyed')."""
    fp = getattr(extractor, "fingerprint", None)
    if cache:
        base = cache.removesuffix(".npz")
        cache = f"{base}.{fp}.npz" if fp else f"{base}.npz"
        if os.path.exists(cache):
            with np.load(cache, allow_pickle=False) as data:
                stored = str(data["fingerprint"]) if "fingerprint" in data else None
                if stored == (fp or "unkeyed"):
                    return data["m1"], data["s1"]
    mu, sigma = calculate_activation_statistics(
        extract_activations(dataset, extractor, batch_size, normalize))
    if cache:
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez(cache, m1=mu, s1=sigma, fingerprint=np.str_(fp or "unkeyed"))
    return mu, sigma
