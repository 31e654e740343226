"""Image FID (counterpart of `cpcsv_tpu/evaluation/fid.py`; reference
`fid/fid_score.py`, `fid/fid_score_v.py`): InceptionV3 pool3 (2048-d)
statistics of two image sets and their Frechet distance. Datasets yield
images (H, W, C); stories (T, H, W, C) are flattened to frames first (the
`fid_score_v` behaviour, fid/fid_score_v.py:87-89)."""

from __future__ import annotations

import numpy as np

from cpcsv_tpu_torch.evaluation.features import activation_statistics
from cpcsv_tpu_torch.evaluation.frechet import calculate_frechet_distance


class FlattenStories:
    """A (T, H, W, C) story dataset as a dataset of its frames."""

    def __init__(self, story_dataset):
        self.ds = story_dataset
        self.T = np.asarray(story_dataset[0]).shape[0]

    def __len__(self):
        return len(self.ds) * self.T

    def __getitem__(self, i):
        return np.asarray(self.ds[i // self.T])[i % self.T]


def fid_score(
    r_imgs,
    g_imgs,
    batch_size: int = 50,
    normalize: bool = False,
    *,
    extractor,
) -> float:
    """FID of `g_imgs` against `r_imgs` (reference fid/fid_score.py:161-183)
    in the features of `extractor`, built once by the caller
    (`inception.make_inception_extractor`)."""
    if np.asarray(r_imgs[0]).ndim == 4:
        r_imgs = FlattenStories(r_imgs)
    if np.asarray(g_imgs[0]).ndim == 4:
        g_imgs = FlattenStories(g_imgs)
    m1, s1 = activation_statistics(r_imgs, extractor, batch_size, normalize)
    m2, s2 = activation_statistics(g_imgs, extractor, batch_size, normalize)
    return calculate_frechet_distance(m1, s1, m2, s2)
