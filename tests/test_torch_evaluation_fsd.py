"""The port's FSD backbone, R(2+1)D-18 (`cpcsv_tpu_torch/evaluation/r2plus1d.py`),
and `fsd_score` against the JAX package's on the CPU, with the same weights
file on both sides: the backbone's features at rtol 5e-3 / atol 5e-4 (the
tolerance of `tests/test_r2plus1d_port.py`), their statistics at 1e-4
relative L2, and FSD over the same folder trees at 1e-3 relative or 1e-6
absolute. The stories are read at 32 x 32, four times cheaper than the
walks' 64 x 64. Helpers and the trees come from `tests/test_torch_evaluation.py`."""

import numpy as np

from cpcsv_tpu.evaluation.datasets import FolderStoryDataset as JaxFolderStoryDataset
from cpcsv_tpu.evaluation.fsd import fsd_score as jax_fsd_score
from cpcsv_tpu_torch.evaluation.datasets import FolderStoryDataset
from cpcsv_tpu_torch.evaluation.fsd import fsd_score
from test_torch_evaluation import SMALL, JaxAtFloat32, backbone_pair, check_features
from test_torch_evaluation import trees  # noqa: F401  (a fixture)
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)


def test_r2plus1d_and_fsd_match_jax_with_the_same_weights(trees, tmp_path):  # noqa: F811
    orig, gen = trees
    ours, ref = backbone_pair(tmp_path, "r2plus1d")
    check_features((ours, ref), FolderStoryDataset(gen, 5, SMALL),
                   JaxFolderStoryDataset(gen, 5, SMALL), 2, False, (4, 512),
                   rtol=5e-3, atol=5e-4)
    expected = jax_fsd_score(JaxFolderStoryDataset(orig, 5, SMALL),
                             JaxFolderStoryDataset(gen, 5, SMALL), batch_size=2,
                             extractor=JaxAtFloat32(ref))
    got = fsd_score(FolderStoryDataset(orig, 5, SMALL), FolderStoryDataset(gen, 5, SMALL),
                    batch_size=2, extractor=ours)
    np.testing.assert_allclose(got, expected, rtol=1e-3, atol=1e-6)
    assert got > 0
