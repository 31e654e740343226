"""The port's CLEVR slice on the CPU: `data/clevr.py` against the JAX
package's datasets on a CLEVR-layout tree written as
`tests/test_clevr_disk.py` writes one, `cli/main_clevr.py` (its flags
against the JAX CLI's, its loaders, a tiny `--synthetic` run with an
auto-resume, bitwise, and the walks of its snapshot at 4 frames a story),
and the in-memory hook's cache tag at 4 frames. The CLEVR-dims D and G
steps are held against the JAX package's in `tests/test_torch_train_step.py`
(`clevr-d`, `clevr-g`), FVD's I3D at 4 frames in `tests/test_torch_i3d.py`."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from cpcsv_tpu.cli import main_clevr as jax_main_clevr
from cpcsv_tpu.data.clevr import ClevrImageDataset as JaxClevrImageDataset
from cpcsv_tpu.data.clevr import ClevrStoryDataset as JaxClevrStoryDataset
from cpcsv_tpu.data.loader import DataLoader as JaxDataLoader
from cpcsv_tpu_torch.cli import main_clevr
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.clevr import ClevrImageDataset, ClevrStoryDataset
from cpcsv_tpu_torch.evaluation import drivers
from test_clevr_disk import _make_fake_clevr
from test_torch_cli import metric_records, tensors
from test_torch_evaluation import StandIn
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The logger writes metrics.jsonl only (as in tests/test_torch_cli.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


@pytest.fixture(scope="module")
def clevr_tree(tmp_path_factory):
    """4 train stories of 4 frames (48 x 64 PNGs and L masks) and their
    18-d attribute codes."""
    return _make_fake_clevr(tmp_path_factory.mktemp("clevr"))


def assert_items_equal(ours, ref):
    assert set(ours) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key


@pytest.mark.parametrize("seed", [0, 7])
def test_clevr_items_match_jax(clevr_tree, seed):
    """Every item of both datasets bit-equal to the JAX package's: the
    frames, the codes, the cumulative 8-d labels and 15-d super labels, the
    image dataset's frame pick from its seeded stream (and after a reseed,
    as the loader's set_epoch does) and its L mask; the fixed id ranges."""
    ours, ref = ClevrStoryDataset(clevr_tree), JaxClevrStoryDataset(clevr_tree)
    assert (len(ours), len(ClevrStoryDataset(clevr_tree, "test"))) == (10000, 3000) == (
        len(ref), len(JaxClevrStoryDataset(clevr_tree, "test")))
    for i in range(4):
        assert_items_equal(ours[i], ref[i])
    assert ours[0]["labels"].shape == (4, 8) and ours[0]["super_labels"].shape == (4, 15)
    ours = ClevrImageDataset(clevr_tree, use_segment=True, seed=seed)
    ref = JaxClevrImageDataset(clevr_tree, use_segment=True, seed=seed)
    picks = []
    for epoch in (None, 1):
        if epoch is not None:
            ours._draws.reseed(epoch)
            ref._draws.reseed(epoch)
        for i in range(4):
            item = ours[i]
            assert_items_equal(item, ref[i])
            picks.append(item["text"])
    assert ours[0]["images_seg"].shape == (64, 64, 1)
    assert len(set(picks)) > 4  # the frame picks differ between items and epochs


def test_clevr_loaders_match_the_jax_cli(clevr_tree):
    """`clevr_loaders` seeds as the JAX CLI does (manualSeed + 10 for the
    frame picks; manualSeed, + 1, + 2 for the image, story and test
    loaders): the first epoch's batches bit-equal, over the tree's 4
    stories."""
    cfg = config_from_file("clevr.yml").with_updates(
        DATA_DIR=clevr_tree, TRAIN=dataclasses.replace(config_from_file("clevr.yml").TRAIN,
                                                       IM_BATCH_SIZE=2, ST_BATCH_SIZE=2))
    ours = main_clevr.clevr_loaders(cfg, seed=3)
    ref = (JaxDataLoader(JaxClevrImageDataset(clevr_tree, use_segment=True, seed=13), 2,
                         shuffle=True, drop_last=True, seed=3),
           JaxDataLoader(JaxClevrStoryDataset(clevr_tree), 2, shuffle=True, drop_last=True,
                         seed=4))
    for a, r in zip(ours, ref):
        for loader in (a, r):  # the tree holds train stories 1-4 only
            loader.dataset.edn = loader.dataset.srt + 4
            loader.set_epoch(0)
        for got, want in zip(a, r):
            assert_items_equal(got, want)
    assert ours[2].dataset.srt == 10001 and not ours[2].shuffle


def test_clevr_flag_surface_matches_jax_cli():
    """Every flag of `cpcsv_tpu/cli/main_clevr.py`, the same defaults (the
    config file clevr.yml) and parsing, and --device and --backend (a multi-process run's
    torch.distributed backend) beside them."""
    argv = ["--cfg", "x.yml", "--continue_ckpt", "auto", "--debug", "--eval_ssim", "1",
            "--manualSeed", "3", "--synthetic", "8", "--max_epoch", "2", "--gpu", "1",
            "--data_dir", "d", "--load_ckpt", "4"]
    ours, ref = vars(main_clevr.parse_args(argv)), vars(jax_main_clevr.parse_args(argv))
    assert ours.pop("device") == "cuda" and ours.pop("backend") is None
    assert ours == ref
    ours, ref = vars(main_clevr.parse_args([])), vars(jax_main_clevr.parse_args([]))
    assert ours.pop("device") == "cuda" and ours.pop("backend") is None
    assert os.path.basename(ours.pop("cfg_file")) == os.path.basename(ref.pop("cfg_file")) \
        == "clevr.yml"
    assert ours == ref


def cli(workdir, *argv):
    here = os.getcwd()
    os.chdir(workdir)
    try:
        out = main_clevr.main(list(argv) + ["--synthetic", "2", "--device", "cpu"])
    finally:
        os.chdir(here)
    return out, os.path.join(workdir, "output", "torch", "tiny_clevr")


def test_clevr_cli_trains_resumes_and_walks(tmp_path, capsys, monkeypatch):
    """clevr.yml at tiny widths through `python -m cpcsv_tpu_torch.cli.main_clevr`:
    two epochs straight equal one and an auto-resumed second, every tensor of
    the state and every metric; the run's tags (v1 with a seg D), 4-frame
    stories of 18-d codes in its snapshot; then --eval_fid 1 and --eval_ssim
    1 over the snapshots at 4 frames a story (stand-in extractors: a 2048-d
    Frechet distance takes ~30 s here) and --load_ckpt 2's numbered PNGs."""
    base = config_from_file("clevr.yml")
    cfg = base.with_updates(CONFIG_NAME="tiny_clevr", GAN=TINY, TRAIN=dataclasses.replace(
        base.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=2, SNAPSHOT_INTERVAL=1))
    cfg_file = tmp_path / "tiny_clevr.yml"
    cfg_file.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    straight, run_dir = cli(tmp_path / "a", "--cfg", str(cfg_file))
    cli(tmp_path / "b", "--cfg", str(cfg_file), "--max_epoch", "1")
    resumed, resumed_dir = cli(tmp_path / "b", "--cfg", str(cfg_file), "--continue_ckpt", "auto")
    assert "Auto-resume from epoch 1" in capsys.readouterr().out
    a, b = tensors(straight), tensors(resumed)
    assert set(a) == set(b) and straight.step == resumed.step == 2
    for key in a:
        assert torch.equal(a[key], b[key]), key
    strip = lambda records: [(r["tag"], r["step"], r["value"]) for r in records  # noqa: E731
                             if not r["tag"].startswith("perf/")]
    records = strip(metric_records(run_dir))
    assert strip(metric_records(resumed_dir)) == records
    assert {t for t, _, _ in records} == (set(chip_smoke.CASCADE_TAGS)
                                          - set(chip_smoke.CASCADE_G_TAGS)
                                          - {"perf/frames_per_sec", "perf/epoch_seconds"})
    snapshot = torch.load(os.path.join(run_dir, "Model", "netG_epoch_2.pth"), weights_only=True)
    assert snapshot["ca_net.fc.weight"].shape == (2 * 124, 18 * 4)
    assert snapshot["recurrent.weight_ih"].shape == (3 * 26, 100 + 26)

    stand_in = StandIn()
    monkeypatch.setattr(drivers, "make_inception_extractor", lambda path, device: stand_in)
    monkeypatch.setattr(drivers, "make_fsd_extractor", lambda path, device: stand_in)
    workdir = tmp_path / "a"
    rows, _ = cli(workdir, "--cfg", str(cfg_file), "--eval_fid", "1")
    assert [r["epoch"] for r in rows] == [2, 1, 0]
    assert all(np.isfinite([r["fid"], r["vfid"]]).all() for r in rows)
    rows, _ = cli(workdir, "--cfg", str(cfg_file), "--eval_ssim", "1")
    assert [r["epoch"] for r in rows] == [2, 1, 0] and np.isfinite([r["ssim"] for r in rows]).all()
    cli(workdir, "--cfg", str(cfg_file), "--load_ckpt", "2")
    pngs = sorted(f"{i}.png" for i in range(1, 2 * 4 + 1))  # 2 test stories of 4 frames
    assert sorted(os.listdir(os.path.join(run_dir, "Evaluation", "samples"))) == pngs
    assert sorted(os.listdir(os.path.join(run_dir, "Evaluation", "ref"))) == pngs


def test_in_memory_hook_tags_its_cache_with_four_frames(tmp_path, monkeypatch):
    """The trainer's FID/FSD hook at clevr.yml's VIDEO_LEN: the real side's
    statistics are cached under the JAX package's tag
    `<data>_<stories>_<imsize>x<frames>`, so a 4-frame run never reads a
    5-frame run's cache; the FSD extractor gets 4-frame stories."""
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.models.factory import generator_from_config

    cfg = config_from_file("clevr.yml").with_updates(GAN=TINY, TRAIN=dataclasses.replace(
        config_from_file("clevr.yml").TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2))
    _, _, testloader = synthetic_loaders(cfg, 2, seed=0)
    net = generator_from_config(cfg).eval()
    seen = []

    class Recording(StandIn):
        def __call__(self, x):
            seen.append(x.shape)
            return super().__call__(x)

    monkeypatch.chdir(tmp_path)
    scores = drivers.evaluate_fid_fsd_in_memory(cfg, net, testloader, torch.Generator(),
                                                extractors=(Recording(), Recording()))
    assert np.isfinite([scores["fid"], scores["fsd"]]).all()
    assert sorted(os.listdir(tmp_path / ".cache")) == [  # the extractor's fingerprint last
        "seg_story_fid_reference_score.data_2_64x4.stand-in.npz",
        "seg_story_vfid_reference_score.data_2_64x4.stand-in.npz"]
    assert any(len(s) == 5 and s[1] == 4 for s in seen)  # (B, T=4, H, W, C) stories

