"""The port's trainer, data loader, synthetic images and sample grids
(`cpcsv_tpu_torch.train.trainer`, `data/`, `utils/image.py`) on the CPU, held
against the JAX package where it computes the same thing: the LR schedule,
the loader's batch order, the synthetic image items and the sample grids;
and what the trainer refuses. Training runs, checkpoints and resume are
driven through the CLI in `test_torch_cli.py`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cpcsv_tpu.data.loader import DataLoader as JaxDataLoader
from cpcsv_tpu.data.loader import WrapAroundIterator as JaxWrapAroundIterator
from cpcsv_tpu.data.synthetic import SyntheticImageDataset as JaxSyntheticImageDataset
from cpcsv_tpu.train.trainer import lr_at_epoch as jax_lr_at_epoch
from cpcsv_tpu.utils import image as jax_image
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.loader import DataLoader, WrapAroundIterator
from cpcsv_tpu_torch.data.synthetic import SyntheticImageDataset
from cpcsv_tpu_torch.train.trainer import GANTrainer, lr_at_epoch
from cpcsv_tpu_torch.utils import image
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

# narrower than the parity tests' widths: these tests check the driver, not the maths
TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


def tiny_cfg(max_epoch=2, snapshot=1):
    """cascade.yml at tiny widths, ST_BATCH 2 / IM_BATCH 4: with 2 synthetic
    stories, one D+G step an epoch."""
    cfg = config_from_file("cascade.yml")
    return cfg.with_updates(GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=max_epoch,
        SNAPSHOT_INTERVAL=snapshot))


def test_lr_schedule_matches_jax():
    for base in (1e-4, 4e-4):
        for decay in (20, 7):
            for epoch in range(201):
                assert lr_at_epoch(base, epoch, decay) == jax_lr_at_epoch(base, epoch, decay)
    assert lr_at_epoch(1e-4, 20, 20) == 1e-4 and lr_at_epoch(1e-4, 21, 20) == 5e-5


@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 1), (7, 12)])
def test_loader_order_matches_jax(seed, epoch):
    """The same items, batched in the same order, for a (seed, epoch), and the
    wrap-around iterator restarting the loader."""
    ds = JaxSyntheticImageDataset(10, use_segment=True, seed=2)
    ours = DataLoader(SyntheticImageDataset(10, use_segment=True, seed=2), 4, shuffle=True,
                      drop_last=True, seed=seed)
    ref = JaxDataLoader(ds, 4, shuffle=True, drop_last=True, seed=seed)
    for loader in (ours, ref):
        loader.set_epoch(epoch)
    ours_batches, ref_batches = list(ours), list(ref)
    assert len(ours_batches) == len(ref_batches) == len(ours) == 2
    for a, r in zip(ours_batches, ref_batches):
        assert set(a) == set(r) and a["text"] == r["text"]
        for key in ("images", "images_seg", "content", "labels"):
            np.testing.assert_array_equal(a[key], r[key])
    # past the end, both restart with the next permutation of the stream
    ours_wrapped, ref_wrapped = WrapAroundIterator(ours), JaxWrapAroundIterator(ref)
    assert ([next(ours_wrapped)["text"] for _ in range(3)]
            == [next(ref_wrapped)["text"] for _ in range(3)])


@pytest.mark.parametrize("use_segment", [True, False])
def test_synthetic_images_match_jax(use_segment):
    ours = SyntheticImageDataset(5, use_segment=use_segment, seed=4)
    ref = JaxSyntheticImageDataset(5, use_segment=use_segment, seed=4)
    for i in (0, 4):
        assert set(ours[i]) == set(ref[i])
        for key, value in ref[i].items():
            if isinstance(value, np.ndarray):
                assert ours[i][key].dtype == value.dtype
                np.testing.assert_array_equal(ours[i][key], value, err_msg=key)
            else:
                assert ours[i][key] == value


def test_sample_grids_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    videos = rng.uniform(-1.1, 1.1, (3, 5, 8, 8, 3)).astype(np.float32)
    real = rng.uniform(-1, 1, (3, 5, 8, 8, 3)).astype(np.float32)
    texts = [[f"story {b} frame {t}" for t in range(5)] for b in range(3)]
    for d in ("ours", "ref"):
        (tmp_path / d).mkdir()
    grid = image.save_story_results(real, videos, texts, "007", str(tmp_path / "ours"))
    ref = jax_image.save_story_results(real, videos, texts, "007", str(tmp_path / "ref"))
    assert grid.dtype == np.uint8
    np.testing.assert_array_equal(grid, ref)
    assert ((tmp_path / "ours" / "fake_samples_007.txt").read_text()
            == (tmp_path / "ref" / "fake_samples_007.txt").read_text())
    masks = rng.uniform(-1, 1, (10, 8, 8, 1)).astype(np.float32)
    np.testing.assert_array_equal(image.save_image_results(masks[::-1], masks, 5),
                                  jax_image.save_image_results(masks[::-1], masks, 5))


@pytest.mark.parametrize("update,match", [
    ({"MESH_SHAPE": "data:4"}, "DDP slice"),
    ("CPCSV_PROFILE_DIR", "tools slice"),
])
def test_trainer_refuses_what_it_does_not_do(update, match, tmp_path, monkeypatch):
    cfg = tiny_cfg()
    if update == "CPCSV_PROFILE_DIR":
        monkeypatch.setenv("CPCSV_PROFILE_DIR", str(tmp_path / "trace"))
    else:
        cfg = cfg.with_updates(**update)
    with pytest.raises(NotImplementedError, match=match):
        GANTrainer(cfg, str(tmp_path), device="cpu")


def test_trainer_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GANTrainer(tiny_cfg(), str(tmp_path))
