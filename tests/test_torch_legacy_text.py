"""The port's legacy StackGAN text loader (`cpcsv_tpu_torch/data/legacy_text.py`)
against the JAX package's (`cpcsv_tpu/data/legacy_text.py`) on the corpus
layouts of `tests/test_legacy_text.py`: every item bit-equal (the bbox crop,
the resize, the seeded embedding pick, per epoch), the class ids, the
transforms, and the same errors."""

import os
import pickle

import numpy as np
import pytest

from cpcsv_tpu.data.legacy_text import TextDataset as JaxTextDataset
from cpcsv_tpu_torch.data.legacy_text import TextDataset
from test_legacy_text import _write_corpus
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.mark.parametrize("layout", ["flowers", "birds"])
def test_items_match_jax(tmp_path, layout):
    root = str(tmp_path / layout)
    _write_corpus(root, n_captions=5, birds=layout == "birds", class_info=layout == "birds")
    for seed in (0, 7):
        ours, ref = TextDataset(root, seed=seed), JaxTextDataset(root, seed=seed)
        assert len(ours) == len(ref) == 4 and ours.bbox == ref.bbox
        np.testing.assert_array_equal(ours.class_id, ref.class_id)
        for epoch in (None, 2):
            if epoch is not None:
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
            for i in range(4):
                (img, emb), (ref_img, ref_emb) = ours[i], ref[i]
                assert img.dtype == ref_img.dtype == np.uint8 and img.shape == (76, 76, 3)
                np.testing.assert_array_equal(img, ref_img)
                np.testing.assert_array_equal(emb, ref_emb)


def test_transforms_and_errors_match_jax(tmp_path):
    root = str(tmp_path / "flowers")
    _write_corpus(root)
    kw = dict(imsize=32, transform=lambda a: a.astype(np.float32) / 255.0,
              target_transform=lambda e: e * 2.0)
    (img, emb), (ref_img, ref_emb) = TextDataset(root, **kw)[1], JaxTextDataset(root, **kw)[1]
    assert img.shape == (38, 38, 3) and img.dtype == np.float32
    np.testing.assert_array_equal(img, ref_img)
    np.testing.assert_array_equal(emb, ref_emb)
    for cls in (TextDataset, JaxTextDataset):
        with pytest.raises(ValueError, match="embedding_type"):
            cls(root, embedding_type="bert")
    with open(os.path.join(root, "train", "filenames.pickle"), "wb") as f:
        pickle.dump(["cls/img_0"], f, protocol=2)
    for cls in (TextDataset, JaxTextDataset):
        with pytest.raises(ValueError, match="embedding rows"):
            cls(root)
