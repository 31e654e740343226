"""The port's FVD and Inception Score (`cpcsv_tpu_torch/evaluation/fvd.py`,
`inception_score.py`, `inception.py:make_inception_classifier`) against the
JAX package's on the CPU, and the `--eval_fvd` / `--eval_is` walks through
the port's CLI.

Tolerances follow `tests/test_torch_evaluation.py`: a backbone's outputs
rtol 1e-2 / atol 1e-3; distances and scores 1e-3 relative or 1e-6
absolute. The FVD comparisons embed clips with the 48-d stand-in of that
file (an I3D forward at 224 x 224 x 10 takes seconds a clip on one CPU
core; `tests/test_torch_i3d.py` holds the I3D itself). The classifier runs
as it is, on 2 frames.

The `cuda`-marked test holds the classifier on the card against the CPU and
skips without a card; JAX is reached through fixtures and inside the tests,
so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_fvd_is.py -m cuda
"""

import csv
import dataclasses
import importlib
import os
import types
import warnings

import numpy as np
import pytest
import torch
import yaml

from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.evaluation import drivers, fvd, inception, inception_score
from cpcsv_tpu_torch.evaluation.datasets import FolderStoryDataset
from cpcsv_tpu_torch.evaluation.i3d import I3D
from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.utils.image import save_all_img, save_png
from torch_cpu import calibrated_backbone
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

CLIPS = 18  # clips a side: rounded down to 16, with the warning, at batch 8


@pytest.fixture(scope="module")
def jax_eval():
    """The JAX package's evaluation modules, imported here so that the
    `cuda`-marked test runs where JAX is absent."""
    return types.SimpleNamespace(**{name: importlib.import_module(f"cpcsv_tpu.evaluation.{name}")
                                    for name in ("fvd", "inception", "inception_score")})


@pytest.fixture(scope="module")
def stand_in():
    from test_torch_evaluation import StandIn

    return StandIn()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Numbered-PNG dumps as `Infer.inference_samples` writes them: CLIPS
    clips of 10 frames a side and 3 frames over, the sides apart."""
    root = tmp_path_factory.mktemp("dumps")
    rng = np.random.default_rng(11)
    for name, shift in (("gen", 0.25), ("ref", 0.0)):
        frames = np.clip(rng.uniform(-1, 1, (CLIPS * 10 + 3, 1, 64, 64, 3)) * 0.7 + shift, -1, 1)
        save_all_img(frames, 0, str(root / name))
    return str(root / "gen"), str(root / "ref")


def test_video_datasets_match_jax(jax_eval, dumps, tmp_path):
    """Clips of numbered PNGs in number order (1, 2, ..., 10, 11: not 1, 10,
    11, 2), the tail left out; and story folders with degree-2 frame swaps
    drawn alike."""
    gen, _ = dumps
    ours, ref = fvd.VideoGenerateDataset(gen), jax_eval.fvd.VideoGenerateDataset(gen)
    assert len(ours) == len(ref) == CLIPS and ours.clips == ref.clips
    assert ours.clips[1][0] == "11.png"
    np.testing.assert_array_equal(ours[CLIPS - 1], ref[CLIPS - 1])
    for s in range(3):
        (tmp_path / str(s)).mkdir()
        for t in range(5):
            save_png(np.full((64, 64, 3), (t - 2) / 3), str(tmp_path / str(s) / f"{t}.png"))
    ours = fvd.VideoFolderDataset(str(tmp_path), degree=2, seed=3)
    ref = jax_eval.fvd.VideoFolderDataset(str(tmp_path), degree=2, seed=3)
    stories = [ours[i] for i in range(3)]
    for i, story in enumerate(stories):
        np.testing.assert_array_equal(story, ref[i])
    flat = FolderStoryDataset(str(tmp_path))
    assert any(not np.array_equal(story, flat[i]) for i, story in enumerate(stories))


def test_calculate_fvd_matches_jax(jax_eval, dumps, stand_in):
    """The same dumps, the same embedder: the same distance, both rounding
    18 clips down to 16 with a warning; the reference's count invariant and
    the too-few-clips error."""
    gen, ref_dir = dumps
    with pytest.warns(UserWarning, match="18 not divisible by 8: using the first 16"):
        ours = fvd.calculate_fvd(gen, ref_dir, num_of_video=32, batch_size=8, embedder=stand_in)
    with pytest.warns(UserWarning, match="using the first 16"):
        ref = jax_eval.fvd.calculate_fvd(gen, ref_dir, num_of_video=32, batch_size=8,
                                         embedder=stand_in)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-6)
    assert ours > 1e-3
    assert abs(fvd.calculate_fvd(gen, gen, num_of_video=16, batch_size=8,
                                 embedder=stand_in)) < 1e-6
    with pytest.raises(AssertionError, match="divisible by 16"):
        fvd.calculate_fvd(gen, ref_dir, num_of_video=100, embedder=stand_in)
    with pytest.raises(ValueError, match="at least 32 clips per side; got gen=18 ref=18"):
        fvd.calculate_fvd(gen, ref_dir, num_of_video=32, batch_size=32, embedder=stand_in)


def test_default_embedder_takes_i3d_only_when_its_weights_resolve(jax_eval, monkeypatch,
                                                                  tmp_path):
    """No I3D file: R(2+1)D ("FVD-R"), warning as random init. A pytorch-i3d
    state_dict named i3d_kinetics400.pth in $CPCSV_METRIC_WEIGHTS_DIR: I3D,
    its weights, for the JAX package as for the port."""
    monkeypatch.setenv("CPCSV_METRIC_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(RandomInitMetricWarning, match="r2plus1d_18"):
        embedder = fvd.default_embedder(device="cpu")
    assert embedder.backbone == "r2plus1d_18" and embedder.random_init
    net = I3D()
    torch.save(net.state_dict(), tmp_path / "i3d_kinetics400.pth")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RandomInitMetricWarning)
        embedder = fvd.default_embedder(device="cpu")
        assert jax_eval.fvd.default_embedder().backbone == "i3d"
    assert embedder.backbone == "i3d" and not embedder.random_init
    assert torch.equal(embedder.net.Mixed_4c.b1b.conv3d.weight, net.Mixed_4c.b1b.conv3d.weight)


def test_inception_score_matches_jax(jax_eval, stand_in):
    """From probabilities (53 of 20 classes, 10 splits: 3 left out), and
    from images through a classifier, batches of 16 and a partial last one,
    [-1, 1] shifted to [0, 1]."""
    rng = np.random.default_rng(12)
    probs = rng.dirichlet(np.full(20, 0.3), 53)
    ours = inception_score.inception_score_from_probs(probs)
    assert ours == jax_eval.inception_score.inception_score_from_probs(probs)
    assert 1 < ours[0] < 20 and ours[1] > 0
    with pytest.raises(ValueError, match="at least splits=10 samples, got 9"):
        inception_score.inception_score_from_probs(probs[:9])
    images = list(rng.uniform(-1, 1, (45, 64, 64, 3)).astype(np.float32))
    seen = []

    def classifier(x):
        seen.append(np.asarray(x))
        return 4.0 * stand_in(x)

    ours = inception_score.inception_score(images, classifier, batch_size=16, normalize=True)
    assert [len(x) for x in seen] == [16, 16, 13] and min(x.min() for x in seen) >= 0
    ref = jax_eval.inception_score.inception_score(images, classifier, batch_size=16,
                                                   normalize=True)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-6)


def test_classifier_matches_jax_from_one_weights_file(jax_eval, tmp_path, monkeypatch):
    """One .npz of a calibrated Inception trunk and a 1008-way fc: the same
    logits from both packages. A trunk-only file or none: the head drawn as
    the JAX package draws it, a warning, the random tag."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    calib, frames = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32) for _ in "ab")
    trunk = {k: v.numpy() for k, v in calibrated_backbone(
        inception.InceptionV3FID(), calib, 5).state_dict().items()}
    head = {"fc.weight": rng.normal(0, 0.05, (1008, 2048)).astype(np.float32),
            "fc.bias": rng.normal(0, 0.1, 1008).astype(np.float32)}
    path = str(tmp_path / "inception_fid.npz")
    np.savez(path, **trunk, **head)
    ours = inception.make_inception_classifier(path, device="cpu")
    ref = jax_eval.inception.make_inception_classifier(path)
    assert not ours.random_init and not ref.random_init
    logits = ours(frames)
    with jax.default_matmul_precision("highest"):
        ref_logits = np.asarray(ref(jnp.asarray(frames)))
    assert logits.shape == (2, 1008)
    np.testing.assert_allclose(logits, ref_logits, rtol=1e-2, atol=1e-3)
    diff, ref_diff = logits[0] - logits[1], ref_logits[0] - ref_logits[1]
    assert np.linalg.norm(diff - ref_diff) < 1e-3 * np.linalg.norm(ref_diff)

    seeded = np.random.default_rng(0).standard_normal((2048, 1008)) * 0.02
    np.savez(path, **trunk)
    with pytest.warns(UserWarning, match="has no fc.weight"):
        trunk_only = inception.make_inception_classifier(path, device="cpu")
    monkeypatch.setenv("CPCSV_METRIC_WEIGHTS_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("HOME", str(tmp_path / "none"))
    with pytest.warns(RandomInitMetricWarning, match="inception_fid"):
        no_file = inception.make_inception_classifier(device="cpu")
    for classifier in (trunk_only, no_file):
        assert classifier.random_init
        np.testing.assert_array_equal(classifier.net.fc.weight.numpy(),
                                      seeded.astype(np.float32).T)
        assert not classifier.net.fc.bias.any()
    assert torch.equal(trunk_only.net.Mixed_7c.branch_pool.conv.weight,
                       torch.from_numpy(trunk["Mixed_7c.branch_pool.conv.weight"]))


# ------------------------------------------------------------------ the CLI
TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A working directory whose ./output/torch/tiny_walk/Model holds
    netG_epoch_{0,2}.pth of a tiny cascade generator (epoch 2's moved away
    from epoch 0's), and its config file (ST_BATCH 2)."""
    cfg = config_from_file("cascade.yml")
    cfg = cfg.with_updates(CONFIG_NAME="tiny_walk", GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2))
    root = tmp_path_factory.mktemp("run")
    (root / "tiny_walk.yml").write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    torch.manual_seed(0)
    gen = generator_from_config(cfg)
    ckpt = CheckpointManager(str(root / "output" / "torch" / "tiny_walk" / "Model"))
    ckpt.save_generator(gen.state_dict(), 0)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(1.5)
    ckpt.save_generator(gen.state_dict(), 2)
    return root


def cli(root, *flags):
    """The port's CLI in `root` on the CPU with 128 synthetic stories, whose
    test loader holds 32 (16 batches of 2): 160 frames, 16 clips of 10."""
    from cpcsv_tpu_torch.cli import main_pororo

    here = os.getcwd()
    os.chdir(root)
    try:
        return main_pororo.main(["--cfg", str(root / "tiny_walk.yml"), "--synthetic", "128",
                                 "--device", "cpu", *flags])
    finally:
        os.chdir(here)


class StandInClassifier:
    """The stand-in's 48 features, scaled, as logits; tagged random."""

    random_init, fingerprint, backbone = True, "stand-in", "stand-in"

    def __init__(self, stand_in):
        self.stand_in = stand_in

    def __call__(self, x):
        return 4.0 * self.stand_in(x)


def test_eval_fvd_and_eval_is_through_the_cli(run, stand_in, monkeypatch, capsys):
    """--eval_fvd 1 and --eval_is 1: one CSV row a snapshot, newest first,
    finite, the rows tagged; the FVD equal to calculate_fvd on the dumps the
    walk wrote, the IS to inception_score on its frames."""
    monkeypatch.setattr(drivers, "default_embedder", lambda path, device: stand_in)
    monkeypatch.setattr(drivers, "make_inception_classifier",
                        lambda path, device: StandInClassifier(stand_in))
    eval_dir = run / "output" / "torch" / "tiny_walk" / "Evaluation" / "tiny_walk"

    rows = cli(run, "--eval_fvd", "1")
    assert [r["epoch"] for r in rows] == [2, 0]
    assert all(r["fvd_random_init"] and np.isfinite(r["fvd"]) for r in rows)
    assert capsys.readouterr().out.count("[RANDOM-INIT embedder!]") == 2
    with open(eval_dir / "fvd_score.csv") as f:
        assert [[float(v) for v in row] for row in csv.reader(f)] == [
            [r["epoch"], r["fvd"]] for r in rows]
    ref_dir = str(run / "output" / "torch" / "tiny_walk" / "Evaluation" / "ref")
    assert len(os.listdir(ref_dir)) == 160
    assert rows[1]["fvd"] == fvd.calculate_fvd(str(eval_dir / "fvd_epoch_0"), ref_dir,
                                               embedder=stand_in)
    assert rows[0]["fvd"] != rows[1]["fvd"]

    rows = cli(run, "--eval_is", "1")
    assert [r["epoch"] for r in rows] == [2, 0]
    assert all(r["is_random_init"] and np.isfinite([r["is_mean"], r["is_std"]]).all()
               for r in rows)
    assert capsys.readouterr().out.count("[RANDOM-INIT classifier!]") == 2
    with open(eval_dir / "is_score.csv") as f:
        assert [[float(v) for v in row] for row in csv.reader(f)] == [
            [r["epoch"], r["is_mean"], r["is_std"]] for r in rows]
    assert sorted(os.listdir(eval_dir / "is_epoch_2")) == ["generate"]
    from cpcsv_tpu_torch.evaluation.datasets import FolderImageDataset

    frames = FolderImageDataset(str(eval_dir / "is_epoch_0" / "generate"))
    assert len(frames) == 160
    assert (rows[1]["is_mean"], rows[1]["is_std"]) == inception_score.inception_score(
        frames, StandInClassifier(stand_in), normalize=True)


def test_save_test_samples_and_inference(run, tmp_path):
    """The reference's other Infer surface: each batch's texts and the
    generated stories with their labels as .npy; `inference`, the numbered
    dump of the loaded snapshot."""
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches

    cfg = config_from_file(str(run / "tiny_walk.yml"))
    infer = drivers.Infer(cfg, device="cpu", output_dir=str(run / "output" / "torch" / "tiny_walk"),
                          load_ckpt=2)
    batches = list(story_batches(SyntheticStoryDataset(4, seed=2), 2))
    infer.save_test_samples(batches, str(tmp_path / "samples"))
    images = np.load(tmp_path / "samples" / "images.npy")
    labels = np.load(tmp_path / "samples" / "labels.npy")
    assert images.shape == (4, 5, 64, 64, 3) and np.isfinite(images).all()
    np.testing.assert_array_equal(labels, np.concatenate([b["labels"] for b in batches]))
    assert {"fake_samples_000.txt", "fake_samples_001.txt"} <= set(os.listdir(tmp_path / "samples"))
    gen_dir, ref_dir = infer.inference(testloader=batches)
    assert gen_dir == os.path.join(infer.eval_dir, "samples")
    assert len(os.listdir(gen_dir)) == len(os.listdir(ref_dir)) == 20


def test_walks_without_snapshots_raise(tmp_path):
    cfg = config_from_file("cascade.yml").with_updates(GAN=TINY)
    infer = drivers.Infer(cfg, device="cpu", output_dir=str(tmp_path))
    for walk in (infer.eval_fvd, infer.eval_is):
        with pytest.raises(FileNotFoundError, match="no generator checkpoints"):
            walk([])


@pytest.mark.cuda
def test_cuda_classifier_matches_cpu():
    """The classifier's network, BN calibrated, a 1008-way head of N(0, 0.05),
    on the card against the CPU, float32 with TF32 off, 4 frames resized
    to 299: raw logits and their differences from the mean at 1e-3
    relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(1)
    calib, x = (rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32) for _ in "ab")
    net = calibrated_backbone(inception.InceptionV3Logits(), calib, 2)
    with torch.no_grad():
        net.fc.weight.normal_(0, 0.05, generator=torch.Generator().manual_seed(3))
    t = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad(), float32_math():
        cpu = net(t).numpy()
        card = net.cuda()(t.cuda()).cpu().numpy()
    for a, b in ((card, cpu), (card - card.mean(0), cpu - cpu.mean(0))):
        assert np.linalg.norm(a - b) < 1e-3 * np.linalg.norm(b)
