"""The port's trainer, data loader, synthetic images and sample grids
(`cpcsv_tpu_torch.train.trainer`, `data/`, `utils/image.py`) on the CPU, held
against the JAX package where it computes the same thing: the LR schedule,
the loader's batch order, the synthetic image items and the sample grids;
what the trainer refuses; and its CPCSV_PROFILE_DIR trace. Training runs, checkpoints and resume are
driven through the CLI in `test_torch_cli.py`.
"""

import dataclasses
import sys

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


@pytest.mark.parametrize("update,error,match", [
    ({"MESH_SHAPE": "data:4"}, ValueError, "spans 4 ranks but the run has 1 process"),
    ({"MESH_SHAPE": "data:1,model:2"}, ValueError, "spans 2 ranks but the run has 1 process"),
    ({"MESH_SHAPE": "data"}, ValueError, "NAME:SIZE"),
])
def test_trainer_refuses_what_it_does_not_do(update, error, match, tmp_path, monkeypatch):
    """MESH_SHAPE is honoured (`parallel/`): a mesh that does not span the
    process group (data:1,model:2 spans two ranks: its model axis
    replicates, it does not shrink), or a malformed one raises; none turns
    into a one-process run."""
    cfg = tiny_cfg().with_updates(**update)
    with pytest.raises(error, match=match):
        GANTrainer(cfg, str(tmp_path), device="cpu")


@pytest.mark.parametrize("mesh_shape", ["", "data:1"])
def test_trainer_takes_a_mesh_of_one_process(mesh_shape, tmp_path):
    """A one-process run with MESH_SHAPE "" or "data:1" builds its trainer as
    before: rank 0 of 1, the metrics logger and the run directory."""
    trainer = GANTrainer(tiny_cfg().with_updates(MESH_SHAPE=mesh_shape), str(tmp_path),
                         device="cpu")
    assert trainer.rank == 0 and (tmp_path / "Model").is_dir()
    assert type(trainer.logger).__name__ == "MetricsLogger"


def test_trainer_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GANTrainer(tiny_cfg(), str(tmp_path))


def test_profile_dir_traces_steps_2_to_5(tmp_path, monkeypatch, capsys):
    """CPCSV_PROFILE_DIR, which the trainer once refused: the first epoch
    with more than 2 steps is traced from its step 2 to its step 5 into that
    directory, one torch.profiler Chrome trace, as the JAX trainer traces
    with jax.profiler (`cpcsv_tpu/train/trainer.py:273-287`); a run whose
    epochs are too short traces nothing and says so. The steps are stand-ins
    that mark themselves with a range and a matmul (profiling a real tiny
    step on the CPU costs seconds; `chip_smoke.py` reads the real kernels
    from the trace on the card)."""
    import json

    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.train import trainer as trainer_module

    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("CPCSV_PROFILE_DIR", str(trace_dir))
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # metrics.jsonl only: seconds less
    steps = []

    def stand_ins(cfg):
        def d_step(state, *args):
            steps.append(len(steps))
            with torch.profiler.record_function(f"test.step_{len(steps) - 1}"):
                return state, {"st_D/loss": torch.ones(2, 2).matmul(torch.ones(2, 2)).sum()}

        return d_step, lambda state, *args: (state, {"G/loss": torch.zeros(())})

    monkeypatch.setattr(trainer_module, "make_train_steps", stand_ins)
    cfg = tiny_cfg(max_epoch=1).with_updates(SCAN_STEPS=1)  # one pair at a time
    GANTrainer(cfg, str(tmp_path / "short"), device="cpu").train(
        *synthetic_loaders(cfg, 4, seed=0))  # 2 steps: too short
    assert not trace_dir.exists()
    assert "CPCSV_PROFILE_DIR was set but no epoch had more than 2 steps" in capsys.readouterr().out
    steps.clear()
    GANTrainer(cfg, str(tmp_path / "run"), device="cpu").train(
        *synthetic_loaders(cfg, 14, seed=0))  # 7 steps
    assert steps == list(range(7))
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = [e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]]
    assert {n for n in names if n and n.startswith("test.step_")} == {
        f"test.step_{i}" for i in range(2, 6)}
    assert names.count("aten::matmul") == 4


def test_profiling_helpers(tmp_path, monkeypatch):
    """`utils/profiling.py`, the JAX module's surface: maybe_trace writes one
    trace of its block into a directory and nothing without one; StepTimer
    keeps the steps after its warm-up; profile_env_dir reads
    CPCSV_PROFILE_DIR, empty as unset."""
    from cpcsv_tpu_torch.utils import profiling

    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(str(tmp_path / "trace")):
        torch.ones(2, 2).matmul(torch.ones(2, 2))
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
    timer = profiling.StepTimer(warmup=1)
    assert np.isnan(timer.mean) and np.isnan(timer.frames_per_sec(10))
    for _ in range(3):
        timer.start()
        timer.stop(sync_on=torch.zeros(1))
    assert len(timer.times) == 2 and timer.frames_per_sec(10) == 10 / timer.mean
    monkeypatch.setenv("CPCSV_PROFILE_DIR", "")
    assert profiling.profile_env_dir() is None
    monkeypatch.setenv("CPCSV_PROFILE_DIR", str(tmp_path))
    assert profiling.profile_env_dir() == str(tmp_path)
