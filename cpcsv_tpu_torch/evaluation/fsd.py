"""FSD (vFID), the Frechet Story Distance, the paper's own metric
(counterpart of `cpcsv_tpu/evaluation/fsd.py`; reference
`fid/vfid_score.py:154-174`): the Frechet distance in the 512-d features of
R(2+1)D-18 over whole stories."""

from __future__ import annotations

from cpcsv_tpu_torch.evaluation.features import activation_statistics
from cpcsv_tpu_torch.evaluation.frechet import calculate_frechet_distance


def fsd_score(
    r_stories,
    g_stories,
    batch_size: int = 50,
    normalize: bool = False,
    r_cache: str | None = None,
    *,
    extractor,
) -> float:
    """FSD of `g_stories` against `r_stories`, items (T, H, W, 3) float, in
    the features of `extractor` (`r2plus1d.make_fsd_extractor`); `r_cache`
    caches the real side's statistics (`features.activation_statistics`).

    The reference's vFID loop takes a `normalize` flag and never applies it
    (fid/vfid_score.py:88-90), so the features come from the [-1, 1]
    stories; the argument is accepted and ignored as there."""
    del normalize
    m1, s1 = activation_statistics(r_stories, extractor, batch_size, False, r_cache)
    m2, s2 = activation_statistics(g_stories, extractor, batch_size, False)
    return calculate_frechet_distance(m1, s1, m2, s2)
