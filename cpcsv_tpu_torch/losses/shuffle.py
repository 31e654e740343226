"""Story-order shuffle augmentation for the order-consistency branch, on the
host in numpy (counterpart of `cpcsv_tpu/losses/shuffle.py`; reference
`create_random_shuffle` / `check_is_order`, miscc/utils.py:17-44).

With probability 1 − random_rate a story stays as it is (label 0); otherwise
its frames are permuted (an already sorted permutation is reshuffled) and,
if a random partner story is another one, one frame of the partner is
spliced in (label 1). The draws from `rng` are the JAX package's, one for
one, so the same `np.random.Generator` state gives the same stories and
labels. Stories are (B, T, H, W, C).
"""

from __future__ import annotations

import numpy as np


def check_is_order(sequence) -> bool:
    return bool((np.diff(sequence) >= 0).all())


def create_random_shuffle(stories: np.ndarray, random_rate: float = 0.5,
                          rng: np.random.Generator | None = None):
    """(shuffled stories, float32 labels (B,))."""
    rng = rng or np.random.default_rng()
    B, T = stories.shape[0], stories.shape[1]
    out = np.empty_like(stories)
    labels = np.zeros((B,), dtype=np.float32)
    for idx in range(B):
        if rng.random() >= random_rate:
            out[idx] = stories[idx]
            continue
        labels[idx] = 1.0
        perm = rng.permutation(T)
        while check_is_order(perm):
            rng.shuffle(perm)
        shuffled = stories[idx, perm].copy()
        partner = int(rng.integers(0, B))
        if partner != idx:
            frame = int(rng.integers(0, T))
            shuffled[frame] = stories[partner, frame]
        out[idx] = shuffled
    return out, labels
