"""The port's Pororo dataset on disk (`cpcsv_tpu_torch/data/`) against the JAX
package's (`cpcsv_tpu/data/`) on the CPU: the procedural writer's files, the
loaders' batches for several (seed, epoch) pairs and the clip-index caches
they write, and the preprocessing of a download. Each side reads its own copy
of a tree, so neither reads a cache the other wrote."""

import dataclasses
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from cpcsv_tpu import config as jax_config
from cpcsv_tpu.data import preprocess as jax_preprocess
from cpcsv_tpu.data.pororo import build_pororo_loaders as jax_build_pororo_loaders
from cpcsv_tpu.data.procedural import write_procedural_pororo as jax_write_procedural
from cpcsv_tpu_torch import config
from cpcsv_tpu_torch.data import preprocess
from cpcsv_tpu_torch.data.pororo import build_pororo_loaders
from cpcsv_tpu_torch.data.procedural import write_procedural_pororo
from tests.test_pororo_disk import _make_fake_pororo
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

EPISODES, FRAMES = 6, 8  # a procedural tree of 24 clips: 20 train, 4 test
SEED_EPOCHS = ((0, 0), (0, 3), (5, 1))
CACHES = ("img_cache4.npy", "following_cache4.npy")


def npy_tree(root):
    """{relative path: bytes} of every .npy and .png file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".npy", ".png")):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = path
    return out


def test_procedural_writer_matches_jax(tmp_path):
    ours = write_procedural_pororo(str(tmp_path / "ours"), EPISODES, FRAMES, seed=3)
    ref = jax_write_procedural(str(tmp_path / "ref"), EPISODES, FRAMES, seed=3)
    assert {**ours, "root": ""} == {**ref, "root": ""}
    a, b = npy_tree(tmp_path / "ours"), npy_tree(tmp_path / "ref")
    assert sorted(a) == sorted(b) and len(a) == 6 + 1 + 2 * EPISODES * FRAMES
    for rel in a:
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a[rel])),
                                          np.asarray(Image.open(b[rel])), err_msg=rel)
        else:
            x = np.load(a[rel], allow_pickle=True)
            y = np.load(b[rel], allow_pickle=True)
            if x.dtype == object and x.shape == ():  # a dict artifact
                x, y = x.item(), y.item()
                assert list(x) == list(y), rel
                for k in x:
                    np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=rel)
            else:  # train_test_ids: (train, test)
                for u, v in zip(x, y):
                    np.testing.assert_array_equal(u, v, err_msg=rel)


def fake_tree(root):
    return _make_fake_pororo(root)[0]


def procedural_tree(root):
    write_procedural_pororo(str(root), EPISODES, FRAMES, seed=1)
    return str(root)


def loaders(make, pkg, root, seed):
    """(image, story, test) loaders of the port ("torch") or the JAX package
    over `root`: cascade.yml's data keys, IM_BATCH 4 / ST_BATCH 2, one device."""
    if pkg == "torch":
        cfg = config.config_from_file("cascade.yml")
        cfg = cfg.with_updates(DATA_DIR=root, TRAIN=dataclasses.replace(
            cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2))
    else:
        cfg = jax_config.config_from_file(
            os.path.join(os.path.dirname(jax_config.__file__), "configs", "cascade.yml"))
        cfg = cfg.with_updates(DATA_DIR=root, MESH_SHAPE="data:1", TRAIN=dataclasses.replace(
            cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2))
    return make(cfg, seed)


def assert_batches_equal(ours, ref, what):
    assert list(ours) == list(ref), what
    for key in ours:
        if isinstance(ours[key], np.ndarray):
            assert ours[key].dtype == ref[key].dtype, (what, key)
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=f"{what} {key}")
        else:
            assert ours[key] == ref[key], (what, key)


@pytest.mark.parametrize("make_tree", [fake_tree, procedural_tree], ids=["fake", "procedural"])
def test_loaders_match_jax(make_tree, tmp_path):
    """Every batch of the three loaders, bit for bit, for each (seed, epoch)
    pair; and the clip-index caches each side wrote into its own tree."""
    root = make_tree(tmp_path / "ours")
    shutil.copytree(root, tmp_path / "ref")
    ref_root = str(tmp_path / "ref") + ("/" if root.endswith("/") else "")
    for seed, epoch in SEED_EPOCHS:
        ours = loaders(build_pororo_loaders, "torch", root, seed)
        ref = loaders(jax_build_pororo_loaders, "jax", ref_root, seed)
        for name, a, b in zip(("image", "story", "test"), ours, ref):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            batches = list(a)
            assert len(batches) == len(b) > 0, name
            for i, (x, y) in enumerate(zip(batches, b)):
                assert_batches_equal(x, y, f"seed {seed} epoch {epoch} {name} batch {i}")
    for f in CACHES:
        assert (tmp_path / "ours" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


def test_an_epochs_draws_come_from_seed_and_epoch(tmp_path):
    """set_epoch reseeds the datasets' crops and description picks: a loader
    that has run other epochs gives epoch 1's batches as a fresh one."""
    root = fake_tree(tmp_path)
    used, fresh = (loaders(build_pororo_loaders, "torch", root, 0)[0] for _ in range(2))
    for epoch in (0, 2):
        used.set_epoch(epoch)
        list(used)
    used.set_epoch(1)
    fresh.set_epoch(1)
    for i, (x, y) in enumerate(zip(used, fresh)):
        assert_batches_equal(x, y, f"batch {i}")


def test_preprocess_matches_jax(tmp_path):
    """GIF episodes to numbered PNGs in scene order, the frames counter, and
    the text dict from a CSV, as the JAX package's."""
    rng = np.random.default_rng(4)
    scenes = tmp_path / "SceneDialogues"
    for ep, n in (("ep_a", 11), ("ep_b", 2)):
        (scenes / ep).mkdir(parents=True)
        for i in range(1, n + 1):
            frames = [Image.fromarray(rng.integers(0, 255, (6, 5, 3), dtype=np.uint8))
                      for _ in range(2)]
            frames[0].save(scenes / ep / f"{i}.gif", save_all=True, append_images=frames[1:])
    (scenes / "notes.txt").write_text("not an episode")
    out = {}
    for name, mod in (("ours", preprocess), ("ref", jax_preprocess)):
        img_dir = str(tmp_path / name)
        count = mod.extract_all(str(scenes), img_dir)
        counter = mod.build_frames_counter(img_dir, str(tmp_path / f"{name}_counter.npy"))
        out[name] = count, counter, npy_tree(img_dir)
    assert out["ours"][:2] == out["ref"][:2] == (13, {"/ep_a/": 11, "/ep_b/": 2})
    assert sorted(out["ours"][2]) == sorted(out["ref"][2])
    for rel, path in out["ours"][2].items():
        np.testing.assert_array_equal(np.asarray(Image.open(path)),
                                      np.asarray(Image.open(out["ref"][2][rel])), err_msg=rel)
    assert (np.load(tmp_path / "ours_counter.npy", allow_pickle=True).item()
            == out["ours"][1])

    csv_path = tmp_path / "descriptions.csv"
    csv_path.write_text('ep_a_1,Pororo runs.\nep_a_1,"Crong, then Eddy."\nep_b_2,Loopy sings\n')

    def vec(text):
        return np.frombuffer(text.encode().ljust(8)[:8], np.uint8).astype(np.float32)

    ours = preprocess.build_text_dict(str(csv_path), vec, str(tmp_path / "ours_text.npy"))
    ref = jax_preprocess.build_text_dict(str(csv_path), vec)
    assert list(ours) == list(ref) == ["ep_a_1", "ep_b_2"]
    for key in ours:
        assert len(ours[key]) == len(ref[key])
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a, b)
    assert list(np.load(tmp_path / "ours_text.npy", allow_pickle=True).item()) == list(ours)
