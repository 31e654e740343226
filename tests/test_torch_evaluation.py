"""The port's evaluation (`cpcsv_tpu_torch/evaluation/`) against the JAX
package's (`cpcsv_tpu/evaluation/`) on the CPU: the two metric backbones with
the same weights (the port's random init, written as one .npz file that both
packages' factories load), SSIM, the Frechet distance, FID and FSD over the
same folder trees; and the checkpoint walks of `Infer` on a tiny run
directory, whose scores must equal the metrics run on the trees they wrote.

Tolerances: the backbones' features as `tests/test_inception_port.py` and
`tests/test_r2plus1d_port.py` hold the JAX converters (rtol 1e-2 / atol 1e-3
and 5e-3 / 5e-4); SSIM 1e-5 relative; feature statistics 1e-4 relative L2;
distances 1e-3 relative or 1e-6 absolute. A Frechet distance of 2048-d
Inception features costs a `scipy.linalg.sqrtm` of ~30 s on one CPU core, so
the FID comparisons and the walks score images with a 48-d stand-in
extractor; the R(2+1)D (512-d) runs as it is.
"""

import csv
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpcsv_tpu.evaluation import fid as jax_fid
from cpcsv_tpu.evaluation import frechet as jax_frechet
from cpcsv_tpu.evaluation.ssim import ssim as jax_ssim
from cpcsv_tpu.evaluation.ssim import ssim_score as jax_ssim_score
from cpcsv_tpu.evaluation.datasets import FolderImageDataset as JaxFolderImageDataset
from cpcsv_tpu.evaluation.datasets import FolderStoryDataset as JaxFolderStoryDataset
from cpcsv_tpu.evaluation.features import extract_activations as jax_extract_activations
from cpcsv_tpu.evaluation.inception import make_inception_extractor as jax_inception
from cpcsv_tpu.evaluation.r2plus1d import make_fsd_extractor as jax_fsd_extractor
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
from cpcsv_tpu_torch.evaluation import drivers, frechet, ssim
from cpcsv_tpu_torch.evaluation.datasets import (
    FolderImageDataset,
    FolderStoryDataset,
    IgnoreLabelDataset,
)
from cpcsv_tpu_torch.evaluation.features import extract_activations
from cpcsv_tpu_torch.evaluation.frechet import calculate_activation_statistics
from cpcsv_tpu_torch.evaluation.fid import fid_score
from cpcsv_tpu_torch.evaluation.fsd import fsd_score
from cpcsv_tpu_torch.evaluation.inception import InceptionV3FID, make_inception_extractor
from cpcsv_tpu_torch.evaluation.r2plus1d import R2Plus1D18, make_fsd_extractor
from cpcsv_tpu_torch.evaluation.weights import Extractor, RandomInitMetricWarning, random_init_
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from torch_cpu import calibrated_backbone
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)
STORIES = 4  # test stories of the tiny run: 2 batches of 2
SMALL = 32  # R(2+1)D reads the trees' stories at 32 x 32 here, 4x cheaper than 64


def relative_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """original/ and generate/ story trees as `Infer.generate_story` writes
    them: 4 stories of 5 frames, written by the port's PNG writer."""
    from cpcsv_tpu_torch.utils.image import save_png

    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(5)
    for name, shift in (("original", 0.0), ("generate", 0.3)):
        for s in range(4):
            d = root / name / str(s)
            d.mkdir(parents=True)
            for t in range(5):
                frame = np.clip(rng.uniform(-1, 1, (64, 64, 3)) * 0.7 + shift, -1, 1)
                save_png(frame, str(d / f"{t}.png"))
    return str(root / "original"), str(root / "generate")


BACKBONES = {  # name: (module, port factory, JAX factory, calibration input shape)
    "inception": (InceptionV3FID, make_inception_extractor, jax_inception, (2, 64, 64, 3)),
    "r2plus1d": (R2Plus1D18, make_fsd_extractor, jax_fsd_extractor, (2, 5, SMALL, SMALL, 3)),
}


def backbone_pair(root, name):
    """(port, JAX) extractors of a backbone from one .npz weights file in the
    torch layout, which both packages' factories load."""
    module, ours, ref, shape = BACKBONES[name]
    x = np.random.default_rng(8).uniform(-1, 1, shape).astype(np.float32)
    sd = calibrated_backbone(module(), x, 7).state_dict()
    path = str(root / f"{name}.npz")
    np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    return ours(path, "cpu"), ref(path)


class JaxAtFloat32:
    """A JAX extractor called at float32 matmul precision."""

    def __init__(self, extractor):
        self.extractor = extractor
        self.fingerprint = extractor.fingerprint

    def __call__(self, x):
        with jax.default_matmul_precision("highest"):
            return np.asarray(self.extractor(jnp.asarray(x)))


def check_features(pair, data, jax_data, batch, normalize, shape, rtol, atol):
    """The pair's features of the two datasets at (rtol, atol), and their
    statistics at 1e-4 relative L2."""
    ours, ref = pair
    assert not ours.random_init and ours.fingerprint == ref.fingerprint
    feats = extract_activations(data, ours, batch, normalize)
    jax_feats = jax_extract_activations(jax_data, JaxAtFloat32(ref), batch, normalize)
    assert feats.shape == shape and feats.dtype == np.float32
    np.testing.assert_allclose(feats, jax_feats, rtol=rtol, atol=atol)
    for a, b in zip(calculate_activation_statistics(feats),
                    jax_frechet.calculate_activation_statistics(jax_feats)):
        assert relative_l2(a, b) < 1e-4


def test_inception_matches_jax_with_the_same_weights(trees, tmp_path):
    """Features of 3 frames of the generate/ tree, on [0, 1], resized 64 ->
    299 inside, and their statistics."""
    data, jax_data = FolderImageDataset(trees[1]), JaxFolderImageDataset(trees[1])
    data.files = jax_data.files = data.files[::7]  # 3 of the tree's 20 frames
    check_features(backbone_pair(tmp_path, "inception"), data, jax_data, 3, True, (3, 2048),
                   rtol=1e-2, atol=1e-3)


def test_random_init_warns_and_tags(monkeypatch, tmp_path):
    """No weights file in the search directories: a warning, random
    LeCun-normal kernels from seed 0, the tags; a named file that is missing
    raises. (A one-layer net stands in for the backbone.)"""
    monkeypatch.setenv("CPCSV_METRIC_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(RandomInitMetricWarning, match="r2plus1d_18"):
        ex = Extractor(torch.nn.Conv3d(3, 8, 3), "r2plus1d_18", None, "cpu")
    assert ex.random_init and ex.fingerprint == "random-init-torch"
    w = ex.net.weight
    assert w.std().item() == pytest.approx(81 ** -0.5, rel=0.1)
    assert torch.equal(w, random_init_(torch.nn.Conv3d(3, 8, 3)).weight)
    assert ex(np.zeros((2, 3, 4, 4, 3))).shape == (2, 8, 1, 2, 2)
    with pytest.raises(FileNotFoundError, match="not found"):
        make_fsd_extractor(str(tmp_path / "missing.npz"), "cpu")


def test_ssim_matches_jax():
    rng = np.random.default_rng(2)
    fake = rng.uniform(-1, 1, (5, 64, 64, 3)).astype(np.float32)
    real = np.clip(fake + rng.normal(0, 0.3, fake.shape), -1, 1).astype(np.float32)
    ours = float(ssim.ssim(torch.from_numpy(fake), torch.from_numpy(real)))
    np.testing.assert_allclose(ours, float(jax_ssim(fake, real)), rtol=1e-5)
    pairs = [(fake, real), (real[:3], fake[:3]), (fake[:2], fake[:2])]
    np.testing.assert_allclose(ssim.ssim_score(iter(pairs), device="cpu"),
                               jax_ssim_score(iter(pairs)),
                               rtol=1e-5)


def test_frechet_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((40, 24))
    b = rng.standard_normal((30, 24)) * 1.3 + 0.2
    for x, y in ((a, b), (a, a), (a[:10], b[:10])):  # 10 rows: singular covariances
        stats = [frechet.calculate_activation_statistics(v) for v in (x, y)]
        for ours, ref in zip(stats, [jax_frechet.calculate_activation_statistics(v)
                                     for v in (x, y)]):
            np.testing.assert_array_equal(ours[0], ref[0])
            np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_allclose(frechet.calculate_frechet_distance(*stats[0], *stats[1]),
                                   jax_frechet.calculate_frechet_distance(*stats[0], *stats[1]),
                                   rtol=1e-3, atol=1e-6)


class StandIn:
    """A 48-d extractor for distances: a fixed random projection of 8 x 8
    pooled colour means of an image (of a story's mean frame), on numpy, the
    same function for both packages."""

    random_init, fingerprint, backbone = True, "stand-in", "stand-in"

    def __init__(self):
        self.w = np.random.default_rng(9).standard_normal((3 * 64, 48)).astype(np.float32)

    def __call__(self, x):
        x = np.asarray(x, np.float32)
        if x.ndim == 5:  # stories: their mean frame
            x = x.mean(axis=1)
        pooled = x.reshape(x.shape[0], 8, 8, 8, 8, 3).mean(axis=(2, 4))
        return np.tanh(pooled.reshape(x.shape[0], -1) @ self.w)


def test_folder_fid_matches_jax(trees):
    """On the same trees: the folder datasets, and FID (stories flattened to
    frames on one side) with the stand-in; the IgnoreLabelDataset view of a
    dict dataset."""
    orig, gen = trees
    for ours, ref in ((FolderStoryDataset(orig), JaxFolderStoryDataset(orig)),
                      (FolderImageDataset(gen), JaxFolderImageDataset(gen))):
        assert len(ours) == len(ref)
        np.testing.assert_array_equal(ours[len(ours) - 1], ref[len(ref) - 1])
    stand_in = StandIn()
    ours = fid_score(FolderStoryDataset(orig), FolderImageDataset(gen), batch_size=7,
                     normalize=True, extractor=stand_in)
    ref = jax_fid.fid_score(JaxFolderStoryDataset(orig), JaxFolderImageDataset(gen),
                            batch_size=7, normalize=True, extractor=stand_in)
    np.testing.assert_allclose(ours, ref, rtol=1e-3, atol=1e-6)
    assert ours > 0
    real = IgnoreLabelDataset([{"images": frame} for frame in FolderImageDataset(gen)])
    assert abs(fid_score(real, FolderImageDataset(gen), batch_size=7, normalize=True,
                         extractor=stand_in)) < 1e-6  # the same data on both sides


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory whose Model/ holds netG_epoch_{0,2}.pth of a tiny
    cascade generator, saved by the port's CheckpointManager (epoch 2's
    weights moved away from epoch 0's); its config; and a test loader."""
    cfg = config_from_file("cascade.yml").with_updates(CONFIG_NAME="tiny_walk", GAN=TINY)
    root = str(tmp_path_factory.mktemp("run"))
    torch.manual_seed(0)
    gen = generator_from_config(cfg)
    ckpt = CheckpointManager(os.path.join(root, "Model"))
    ckpt.save_generator(gen.state_dict(), 0)
    with torch.no_grad():
        for p in gen.parameters():
            p.mul_(1.5)
    ckpt.save_generator(gen.state_dict(), 2)
    return cfg, root


def test_load_epoch_and_the_samples_dump(run_dir):
    cfg, root = run_dir
    infer = drivers.Infer(cfg, device="cpu", output_dir=root)
    with pytest.raises(RuntimeError, match="no generator weights"):
        infer.sample_videos_np(next(story_batches(SyntheticStoryDataset(2), 2)))
    with pytest.raises(FileNotFoundError, match=os.path.join(root, "Model")):
        infer.load_epoch(1)
    infer = drivers.Infer(cfg, device="cpu", output_dir=root, load_ckpt=2)
    save = os.path.join(root, "Evaluation", "samples")
    os.makedirs(save)
    open(os.path.join(save, "99.png"), "w").close()  # a stale frame of a larger dump
    loader = story_batches(SyntheticStoryDataset(STORIES, seed=4), 2)
    gen_dir, ref_dir = infer.inference_samples(loader, save)
    want = sorted(f"{i}.png" for i in range(1, STORIES * cfg.VIDEO_LEN + 1))
    assert sorted(os.listdir(gen_dir)) == sorted(os.listdir(ref_dir)) == want


class Loader:
    """A test loader as the walks take it: batches, and `.dataset`."""

    def __init__(self, dataset, batch):
        self.dataset, self.batch = dataset, batch

    def __iter__(self):
        return story_batches(self.dataset, self.batch)


def test_walks_score_the_trees_they_write(run_dir, monkeypatch, capsys):
    """eval_fid2 and eval_ssim_walk over epochs [2, 0]: rows newest first,
    appended to the CSVs, tagged; FID and FSD equal to fid_score and
    fsd_score run on the trees the walk wrote; SSIM equal to ssim_score of
    the stories regenerated with the same noise."""
    cfg, root = run_dir
    stand_in, story_stand_in = StandIn(), StandIn()
    story_stand_in.random_init = False  # so the two tags are told apart
    monkeypatch.setattr(drivers, "make_inception_extractor", lambda path, device: stand_in)
    monkeypatch.setattr(drivers, "make_fsd_extractor", lambda path, device: story_stand_in)
    loader = Loader(SyntheticStoryDataset(STORIES, seed=4), 2)
    infer = drivers.Infer(cfg, device="cpu", output_dir=root, seed=3)
    rows = infer.eval_fid2(loader, batch_size=6)
    assert [r["epoch"] for r in rows] == [2, 0]
    assert all(r["fid_random_init"] and not r["fsd_random_init"] for r in rows)
    assert "[RANDOM-INIT extractors!]" in capsys.readouterr().out
    for r in rows:
        tree = os.path.join(infer.eval_dir, f"epoch_{r['epoch']}")
        orig, gen = os.path.join(tree, "original"), os.path.join(tree, "generate")
        assert len(os.listdir(gen)) == STORIES
        assert r["vfid"] == fsd_score(FolderStoryDataset(orig), FolderStoryDataset(gen),
                                      batch_size=4, extractor=story_stand_in)
        assert r["fid"] == fid_score(FolderImageDataset(orig), FolderImageDataset(gen),
                                     batch_size=6, normalize=True, extractor=stand_in)
    with open(os.path.join(infer.eval_dir, "fid_score2.csv")) as f:
        assert [[float(v) for v in row] for row in csv.reader(f)] == [
            [r["epoch"], r["fid"], r["vfid"]] for r in rows]
    assert rows[0]["fid"] != rows[1]["fid"]

    state = infer.generator.get_state()
    walk = infer.eval_ssim_walk(loader, n=3)
    assert [r["epoch"] for r in walk] == [2, 0]
    infer.generator.set_state(state)
    infer.load_epoch(2)
    # the walk generated the loader's 4 stories in one chunk and scored 3
    items = [loader.dataset[i] for i in range(STORIES)]
    fake, _ = infer.sample_videos_np(
        {k: np.stack([it[k] for it in items]) for k in ("description", "labels")})
    expected = ssim.ssim_score(zip(fake[:3], [it["images"] for it in items[:3]]), device="cpu")
    np.testing.assert_allclose(walk[0]["ssim"], expected, rtol=1e-6)
    infer.eval_ssim_walk(loader, epochs=[0], n=3)
    with open(os.path.join(infer.eval_dir, "ssim_score.csv")) as f:
        assert [row[0] for row in csv.reader(f)] == ["2", "0", "0"]


def test_walk_without_snapshots_raises(tmp_path):
    cfg = config_from_file("cascade.yml").with_updates(GAN=TINY)
    infer = drivers.Infer(cfg, device="cpu", output_dir=str(tmp_path))
    for walk in (infer.eval_fid2, infer.eval_ssim_walk):
        with pytest.raises(FileNotFoundError, match="no generator checkpoints"):
            walk(Loader(SyntheticStoryDataset(2), 2))


def test_entry_points_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RandomInitMetricWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_fsd_extractor()
    cfg = dataclasses.replace(config_from_file("cascade.yml"), GAN=TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        drivers.Infer(cfg)
