"""The trainer's in-training FID/FSD (`EVALUATE_FID_SCORE`,
`cpcsv_tpu_torch.train.trainer.GANTrainer.calculate_vfid` over
`evaluation.drivers.evaluate_fid_fsd_in_memory`) on the CPU.

`evaluate_fid_fsd_in_memory` is held against the JAX package's on one
generator snapshot and the same test items, both generators' noise fixed to
the same arrays (the harness of `tests/test_torch_evaluation_walks.py`),
with the 48-d stand-in extractors of `tests/test_torch_evaluation.py` (a
2048-d Frechet distance is ~30 s of one CPU core): distances at 1e-3
relative or 1e-6 absolute, the generated stories agreeing to 2e-3. The
real side's statistics go to ./.cache/, keyed by the test set and the
extractor's fingerprint, and are read back. Then two tiny epochs of the
trainer with the hook: the scalars, the extractors built once, the cache.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from cpcsv_tpu.evaluation import drivers as jax_drivers
from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.evaluation import drivers
from cpcsv_tpu_torch.train import trainer as trainer_module
from cpcsv_tpu_torch.train.trainer import GANTrainer
from test_torch_evaluation import StandIn
from test_torch_evaluation_walks import STORIES, jax_fixed_noise, walkers  # noqa: F401
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The logger writes metrics.jsonl only (`tests/test_torch_cli.py`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


class Counted(StandIn):
    """The stand-in, counting the items of each call in `calls`."""

    def __init__(self, fingerprint):
        super().__init__()
        self.fingerprint, self.calls = fingerprint, []

    def __call__(self, x):
        self.calls.append(len(x))
        return super().__call__(x)


class Loader:
    """A test loader as the hook takes it: `.dataset`."""

    def __init__(self, items):
        self.dataset = items


def test_in_memory_fid_fsd_matches_jax(walkers, jax_fixed_noise, tmp_path,  # noqa: F811
                                       monkeypatch):
    ours, ref, items = walkers
    cfg = ours.cfg.with_updates(DATA_DIR="/data/pororo/")
    scores = []
    for side, run in (("port", lambda ex: drivers.evaluate_fid_fsd_in_memory(
            cfg, ours.net_g, Loader(items), ours.generator, extractors=ex)),
                      ("jax", lambda ex: jax_drivers.evaluate_fid_fsd_in_memory(
            ref.cfg.with_updates(DATA_DIR="/data/pororo/"), ref.net_g, ref._gen_vars,
            Loader(items), ref.rng, extractors=ex))):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        extractors = Counted("fid-stand-in"), Counted("fsd-stand-in")
        scores.append(run(extractors))
        # each side: the real and the generated items once, in one batch each
        assert extractors[0].calls == [STORIES * 5] * 2 and extractors[1].calls == [STORIES] * 2
    (port, jax_scores) = scores
    for key in ("fid", "fsd"):
        np.testing.assert_allclose(port[key], jax_scores[key], rtol=1e-3, atol=1e-6)
        assert port[key] > 1e-3
    assert port["fid_random_init"] and port["fsd_random_init"]
    assert sorted(os.listdir(".cache")) == sorted(os.listdir(tmp_path / "port" / ".cache")) == [
        f"seg_story_fid_reference_score.pororo_{STORIES}_64x5.fid-stand-in.npz",
        f"seg_story_vfid_reference_score.pororo_{STORIES}_64x5.fsd-stand-in.npz"]

    # the port again, from its .cache: the real side is read, not extracted
    monkeypatch.chdir(tmp_path / "port")
    extractors = Counted("fid-stand-in"), Counted("fsd-stand-in")
    again = drivers.evaluate_fid_fsd_in_memory(cfg, ours.net_g, Loader(items), ours.generator,
                                               extractors=extractors)
    assert extractors[0].calls == [STORIES * 5] and extractors[1].calls == [STORIES]
    assert np.isfinite([again["fid"], again["fsd"]]).all()
    # another fingerprint (other weights) never reads those statistics
    other = Counted("other"), Counted("fsd-stand-in")
    drivers.evaluate_fid_fsd_in_memory(cfg, ours.net_g, Loader(items), ours.generator,
                                       extractors=other)
    assert other[0].calls == [STORIES * 5] * 2 and len(os.listdir(".cache")) == 3


TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


def test_trainer_hook_over_two_epochs(tmp_path, monkeypatch):
    """rehearsal.yml at tiny widths, 2 epochs of one step: Evaluation/fid and
    Evaluation/vfid each epoch, finite, logged before the epoch's seconds;
    the extractors built once; the real side extracted in epoch 0 only; the
    generator back in train mode; and calculate_ssim on demand."""
    cfg = config_from_file("rehearsal.yml")
    assert cfg.EVALUATE_FID_SCORE and cfg.TRAIN.SNAPSHOT_INTERVAL == 1
    cfg = cfg.with_updates(GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=2))
    built = []

    def make(device):
        built.append((Counted("fid-stand-in"), Counted("fsd-stand-in")))
        return built[-1]

    monkeypatch.setattr(trainer_module, "make_in_memory_extractors", make)
    monkeypatch.chdir(tmp_path)
    loaders = synthetic_loaders(cfg, 2, seed=0)
    trainer = GANTrainer(cfg, str(tmp_path / "run"), device="cpu")
    state = trainer.train(*loaders)
    assert len(built) == 1
    fid_ex, fsd_ex = built[0]
    test_stories = len(loaders[2].dataset)
    assert fid_ex.calls == [test_stories * 5] * 3 and fsd_ex.calls == [test_stories] * 3
    assert len(os.listdir(".cache")) == 2
    assert state.gen.training
    with open(tmp_path / "run" / "log" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    tags = [(r["tag"], r["step"]) for r in records]
    for epoch in (0, 1):
        for tag in ("Evaluation/fid", "Evaluation/vfid"):
            assert tags.index((tag, epoch)) < tags.index(("perf/epoch_seconds", epoch))
    assert all(np.isfinite(r["value"]) for r in records if r["tag"].startswith("Evaluation/"))
    # a snapshot every epoch, and the final one
    assert {f"netG_epoch_{e}.pth" for e in (0, 1, 2)} <= set(os.listdir(tmp_path / "run" / "Model"))

    value = trainer.calculate_ssim(state, 1, loaders[2])
    assert -1 < value < 1 and state.gen.training
    trainer.logger.flush()
    with open(tmp_path / "run" / "log" / "metrics.jsonl") as f:
        assert any(json.loads(line)["tag"] == "Evaluation/ssim" for line in f)


def test_hook_without_a_card_raises(monkeypatch, tmp_path):
    """The hook's extractors and SSIM follow the trainer's device: cuda by
    default, and no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drivers.make_in_memory_extractors()
    from cpcsv_tpu_torch.evaluation.ssim import ssim_score

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssim_score(iter([]))
