"""The port's training CLI end to end (`cpcsv_tpu_torch.cli.main_pororo`, the
trainer and the checkpoints behind it) on the CPU at tiny widths: its flags
against the JAX package's CLI; a 2-epoch run, its artifacts and its final
save; two epochs straight equal to one and an auto-resume for one more,
bitwise; an explicit --continue_ckpt E restarting at E; a kill between
staging the full state and its swap; the run's netG_epoch_0.pth read by the JAX
package's converter (`utils/port_torch.py:port_generator_file`); and what
the CLI refuses. After the JAX package's `tests/test_e2e_training.py` and
`tests/test_cli_e2e.py`.
"""

import csv
import dataclasses
import json
import os
import shutil
import sys
from unittest import mock

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from cpcsv_tpu.cli import main_pororo as jax_main_pororo
from cpcsv_tpu.utils.port_torch import port_generator_file
from cpcsv_tpu_torch.cli import main_pororo
from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.procedural import write_procedural_pororo
from cpcsv_tpu_torch.evaluation import drivers
from cpcsv_tpu_torch.train import checkpoint
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.train.trainer import GANTrainer
from cpcsv_tpu_torch.utils.weights import generator_state_dict_from_jax
from test_torch_evaluation import StandIn
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

# narrower than the parity tests' widths: these tests check the driver, not the maths
TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)
SYNTHETIC = "2"  # 2 stories at ST_BATCH 2, 4 images at IM_BATCH 4: one step an epoch


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The logger writes metrics.jsonl only: importing tensorboardX takes
    seconds, and nothing here reads its event files."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


@pytest.fixture(scope="module")
def cfg_file(tmp_path_factory):
    """cascade.yml at tiny widths, ST_BATCH 2 / IM_BATCH 4, snapshots every
    epoch, as a config file."""
    cfg = config_from_file("cascade.yml")
    cfg = cfg.with_updates(CONFIG_NAME="tiny_cascade", GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=2, SNAPSHOT_INTERVAL=1))
    path = tmp_path_factory.mktemp("cfg") / "tiny_cascade.yml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return str(path)


def cli(workdir, *argv, data=("--synthetic", SYNTHETIC)):
    """The CLI's main in `workdir` on the CPU, on the synthetic data unless
    `data` says otherwise: (what main returns, the run directory)."""
    here = os.getcwd()
    os.chdir(workdir)
    try:
        out = main_pororo.main(list(argv) + list(data) + ["--device", "cpu"])
    finally:
        os.chdir(here)
    return out, os.path.join(workdir, "output", "torch", "tiny_cascade")


@pytest.fixture(scope="module")
def straight(tmp_path_factory, cfg_file):
    """Two epochs straight through the CLI: (run directory, final state)."""
    state, run_dir = cli(tmp_path_factory.mktemp("straight"), "--cfg", cfg_file)
    return run_dir, state


def tensors(state):
    """Every tensor of a TrainState: the nets' state_dicts and the Adam states."""
    out = {}
    for name, net in state.nets().items():
        out.update({f"{name}.{k}": v for k, v in net.state_dict().items()})
        for i, s in state.opts[name].state_dict()["state"].items():
            out.update({f"{name}.adam.{i}.{k}": v for k, v in s.items()})
    return out


def metric_records(run_dir):
    with open(os.path.join(run_dir, "log", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_flag_surface_matches_jax_cli():
    """Every flag of the JAX package's CLI, the same defaults and parsing, and
    --device beside them."""
    argv = ["--cfg", "x.yml", "--continue_ckpt", "auto", "--debug", "--eval_fvd", "0",
            "--manualSeed", "3", "--synthetic", "8", "--max_epoch", "2", "--gpu", "1",
            "--data_dir", "d", "--load_ckpt", "4"]
    ours, ref = vars(main_pororo.parse_args(argv)), vars(jax_main_pororo.parse_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == ref
    ours, ref = vars(main_pororo.parse_args([])), vars(jax_main_pororo.parse_args([]))
    assert ours.pop("device") == "cuda"
    assert os.path.basename(ours.pop("cfg_file")) == os.path.basename(ref.pop("cfg_file"))
    assert ours == ref
    assert main_pororo.parse_args(["--device", "cpu"]).device == "cpu"


def test_cli_run_writes_the_artifacts(straight):
    run_dir, state = straight
    assert state.step == 2
    for name in ("setting.yml", "generator.py", "trainer.py", "log/pororo_00000.png",
                 "log/pororo_00001.png", "log/segment_00001.png",
                 "Image/fake_samples_001.txt"):
        assert os.path.isfile(os.path.join(run_dir, name)), name
    records = metric_records(run_dir)
    assert {r["tag"] for r in records} == set(chip_smoke.CASCADE_TAGS)
    assert all(set(r) == {"tag", "value", "step", "ts"} and np.isfinite(r["value"])
               for r in records)


def test_final_save_is_named_max_epoch_and_labelled_the_last_epoch(straight):
    run_dir, _ = straight
    model = os.path.join(run_dir, "Model")
    assert sorted(os.listdir(model)) == [
        "last_epoch.txt", "netD_im_epoch_last.pth", "netD_se_epoch_last.pth",
        "netD_st_epoch_last.pth", "netG_epoch_0.pth", "netG_epoch_1.pth", "netG_epoch_2.pth",
        "train_state_last.pth"]
    ckpt = CheckpointManager(model)
    assert ckpt.available_generator_epochs() == [0, 1, 2]
    assert ckpt.last_epoch() == 1
    assert open(os.path.join(model, "last_epoch.txt")).read() == "1"
    assert torch.load(os.path.join(model, checkpoint.STATE_FILE),
                      weights_only=True)["COMPLETED_EPOCH"] == 1


def test_auto_resume_reproduces_the_straight_run_bitwise(straight, cfg_file, tmp_path, capsys):
    """One epoch, then --max_epoch 2 --continue_ckpt auto, equals two epochs
    straight: every parameter, buffer and Adam moment, and every logged
    metric."""
    run_dir, state = straight
    cli(tmp_path, "--cfg", cfg_file, "--max_epoch", "1")
    resumed, resumed_dir = cli(tmp_path, "--cfg", cfg_file, "--max_epoch", "2",
                               "--continue_ckpt", "auto")
    assert "Auto-resume from epoch 1" in capsys.readouterr().out
    a, b = tensors(state), tensors(resumed)
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert resumed.step == state.step == 2
    strip = lambda records: [(r["tag"], r["step"], r["value"]) for r in records  # noqa: E731
                             if not r["tag"].startswith("perf/")]
    assert strip(metric_records(resumed_dir)) == strip(metric_records(run_dir))


def test_continue_ckpt_e_restarts_at_e(straight, cfg_file, tmp_path, capsys):
    """--continue_ckpt 0: the full state, then the generator of epoch 0's
    snapshot, and training restarts at epoch 0 (the reference's semantics)."""
    run_dir, _ = straight
    shutil.copytree(os.path.join(run_dir, "Model"), tmp_path / "Model")
    cfg = config_from_file(cfg_file)
    image_loader, story_loader, test_loader = synthetic_loaders(cfg, int(SYNTHETIC), seed=0)
    epochs, restored = [], {}
    story_loader.set_epoch = epochs.append

    def stop(state, *args):
        restored.update(tensors(state))
        raise KeyboardInterrupt

    trainer = GANTrainer(cfg, str(tmp_path), continue_ckpt="0", seed=0, device="cpu")
    trainer.d_step = stop
    with pytest.raises(KeyboardInterrupt):
        trainer.train(image_loader, story_loader, test_loader)
    assert "Continue training from epoch 0" in capsys.readouterr().out
    assert epochs == [0]
    snapshot = torch.load(tmp_path / "Model" / "netG_epoch_0.pth", weights_only=True)
    final = torch.load(tmp_path / "Model" / checkpoint.STATE_FILE, weights_only=True)
    assert not torch.equal(snapshot["fc.0.weight"], final["nets"]["gen"]["fc.0.weight"])
    for key, value in snapshot.items():
        assert torch.equal(restored[f"gen.{key}"], value), key
    for key, value in final["nets"]["d_im"].items():
        assert torch.equal(restored[f"d_im.{key}"], value), key


def test_a_kill_inside_the_state_swap_still_restores(straight, tmp_path):
    """A kill after the new full state is staged and before it replaces the
    old one: restore and last_epoch see the old state, and the next save
    replaces the staged file."""
    run_dir, state = straight
    ckpt = CheckpointManager(str(tmp_path / "Model"))
    shutil.copytree(os.path.join(run_dir, "Model"), ckpt.model_dir, dirs_exist_ok=True)
    final = os.path.join(ckpt.model_dir, checkpoint.STATE_FILE)
    saved = state.gen.fc[0].weight.detach().clone()
    with torch.no_grad():
        state.gen.fc[0].weight += 1.0  # a state the saved one is not
    moved = state.gen.fc[0].weight.detach().clone()
    real_replace = checkpoint._replace_synced

    def killed(tmp, target):
        if target == final:
            raise KeyboardInterrupt("before the swap")
        real_replace(tmp, target)

    with mock.patch.object(checkpoint, "_replace_synced", killed), \
            pytest.raises(KeyboardInterrupt):
        ckpt.save(state, 5)
    assert os.path.exists(final + ".tmp") and ckpt.last_epoch() == 1
    ckpt.restore(state)
    assert torch.equal(state.gen.fc[0].weight, saved)
    with torch.no_grad():
        state.gen.fc[0].weight.copy_(moved)
    ckpt.save(state, 5)
    assert ckpt.last_epoch() == 5 and not os.path.exists(final + ".tmp")
    ckpt.restore(state)
    assert torch.equal(state.gen.fc[0].weight, moved)
    # the module fixture's state as it was: its run's own last save
    CheckpointManager(os.path.join(run_dir, "Model")).restore(state)


def test_jax_package_reads_the_run_snapshot(straight):
    """The run's netG_epoch_0.pth through the JAX package's
    `port_generator_file` holds the file's weights and BN statistics
    exactly (`tests/test_torch_generator.py` samples such a snapshot on both
    sides)."""
    run_dir, _ = straight
    path = os.path.join(run_dir, "Model", "netG_epoch_0.pth")
    saved = torch.load(path, weights_only=True)
    ported = generator_state_dict_from_jax(
        port_generator_file(path, use_segment=True, cascade=True), cascade=True)
    assert set(ported) == set(saved)
    for key, value in saved.items():
        if not key.endswith("num_batches_tracked"):  # the JAX tree keeps no count
            assert torch.equal(ported[key], value), key


@pytest.mark.parametrize("argv,error,match", [
    ([], ValueError, "--data_dir DIR .* Pororo dataset loader, or --synthetic N"),
], ids=["argv2-Pororo dataset loader"])
def test_cli_refuses_what_the_port_does_not_do(argv, error, match, cfg_file, tmp_path,
                                               monkeypatch):
    """Without data the CLI names both of its sources."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(error, match=match):
        main_pororo.main(["--cfg", cfg_file, "--device", "cpu"] + argv)
    assert not (tmp_path / "output").exists()


# ------------------------------------------------------------------ from disk
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A procedural Pororo tree of 3 episodes of 7 frames written by the
    port: 9 clips, 5 for training (2 story steps an epoch at ST_BATCH 2, one
    image batch at 4 that wraps) and 4 for the test loader."""
    root = str(tmp_path_factory.mktemp("pororo"))
    write_procedural_pororo(root, n_episodes=3, frames_per_episode=7, test_frac=0.45)
    return root


@pytest.fixture(scope="module")
def disk_straight(tmp_path_factory, cfg_file, data_dir):
    """Two epochs straight through the CLI with --data_dir: (run directory,
    final state)."""
    state, run_dir = cli(tmp_path_factory.mktemp("disk"), "--cfg", cfg_file,
                         data=("--data_dir", data_dir))
    return run_dir, state


def test_data_dir_trains_and_resumes_exactly(disk_straight, cfg_file, data_dir, tmp_path):
    """--data_dir: 2 story steps an epoch, the run's artifacts, and one
    epoch then --continue_ckpt auto equal to two straight, bitwise (the
    datasets' crops and description picks come from (seed, epoch))."""
    run_dir, state = disk_straight
    assert state.step == 4
    assert os.path.isfile(os.path.join(data_dir, "img_cache4.npy"))
    records = metric_records(run_dir)
    assert {r["tag"] for r in records} == set(chip_smoke.CASCADE_TAGS)
    assert all(np.isfinite(r["value"]) for r in records)
    data = ("--data_dir", data_dir)
    cli(tmp_path, "--cfg", cfg_file, "--max_epoch", "1", data=data)
    resumed, _ = cli(tmp_path, "--cfg", cfg_file, "--continue_ckpt", "auto", data=data)
    a, b = tensors(state), tensors(resumed)
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_walks_through_the_cli(disk_straight, cfg_file, data_dir, monkeypatch, capsys):
    """--eval_fid 1, --eval_ssim 1 and --load_ckpt 2 on the run: one CSV
    row a snapshot, newest first, finite and tagged; the numbered PNGs of
    the test stories. Stand-in extractors keep the Frechet distances small
    (`tests/test_torch_evaluation.py`)."""
    run_dir, _ = disk_straight
    workdir = os.path.dirname(os.path.dirname(os.path.dirname(run_dir)))
    data = ("--data_dir", data_dir)
    stand_in = StandIn()
    monkeypatch.setattr(drivers, "make_inception_extractor", lambda path, device: stand_in)
    monkeypatch.setattr(drivers, "make_fsd_extractor", lambda path, device: stand_in)
    rows, _ = cli(workdir, "--cfg", cfg_file, "--eval_fid", "1", data=data)
    assert [r["epoch"] for r in rows] == [2, 1, 0]
    assert all(np.isfinite([r["fid"], r["vfid"]]).all() and r["fid_random_init"]
               and r["fsd_random_init"] for r in rows)
    assert capsys.readouterr().out.count("[RANDOM-INIT extractors!]") == 3
    eval_dir = os.path.join(run_dir, "Evaluation", "tiny_cascade")
    with open(os.path.join(eval_dir, "fid_score2.csv")) as f:
        assert [float(row[0]) for row in csv.reader(f)] == [2, 1, 0]
    rows, _ = cli(workdir, "--cfg", cfg_file, "--eval_ssim", "1", data=data)
    assert [r["epoch"] for r in rows] == [2, 1, 0] and np.isfinite([r["ssim"] for r in rows]).all()
    with open(os.path.join(eval_dir, "ssim_score.csv")) as f:
        assert [float(row[1]) for row in csv.reader(f)] == [r["ssim"] for r in rows]
    (gen_dir, ref_dir), _ = cli(workdir, "--cfg", cfg_file, "--load_ckpt", "2", data=data)
    assert gen_dir == os.path.join(".", "output", "torch", "tiny_cascade", "Evaluation", "samples")
    pngs = sorted(f"{i}.png" for i in range(1, 4 * 5 + 1))  # 4 test stories of 5 frames
    assert sorted(os.listdir(os.path.join(run_dir, "Evaluation", "samples"))) == pngs
    assert sorted(os.listdir(os.path.join(run_dir, "Evaluation", "ref"))) == pngs
