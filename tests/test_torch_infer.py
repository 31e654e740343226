"""The port's serving entry point (`cpcsv_tpu_torch.evaluation.drivers.Infer`),
its config and synthetic stories against the JAX package's, and the rule
that the port imports nothing of JAX or of the JAX package."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.data.synthetic import SyntheticStoryDataset as JaxSyntheticStoryDataset
from cpcsv_tpu.utils import image as jax_image
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
from cpcsv_tpu_torch.evaluation.drivers import Infer
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.utils import image
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
TINY = GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=16, GF_DIM=8, GF_SEG_DIM=32)


@pytest.fixture(scope="module")
def cascade_setup():
    cfg = config_from_file("cascade.yml").with_updates(GAN=TINY)
    torch.manual_seed(0)
    return cfg, generator_from_config(cfg).state_dict()


def test_sample_videos_np_shapes_and_determinism(cascade_setup, tmp_path):
    cfg, state = cascade_setup
    batch = next(story_batches(SyntheticStoryDataset(3, seed=5), 3))
    runs = [Infer(cfg, state, device="cpu", output_dir=str(tmp_path), seed=1)
            .sample_videos_np(batch, seg=True) for _ in range(2)]
    video, mask = runs[0]
    assert video.shape == (3, 5, 64, 64, 3) and video.dtype == np.float32
    assert mask.shape == (15, 64, 64, 1)
    assert np.isfinite(video).all() and np.abs(video).max() <= 1
    np.testing.assert_array_equal(video, runs[1][0])


def test_generate_story_writes_both_trees(cascade_setup, tmp_path):
    cfg, state = cascade_setup
    infer = Infer(cfg, state, device="cpu", output_dir=str(tmp_path))
    orig, gen = infer.generate_story(story_batches(SyntheticStoryDataset(3), 2), "walk")
    for root in (orig, gen):
        assert sorted(os.listdir(root)) == ["0", "1", "2"]
        assert sum(len(files) for _, _, files in os.walk(root)) == 3 * 5
    assert gen == os.path.join(str(tmp_path), "Evaluation", "cascade_model", "walk", "generate")


def test_sample_videos_np_holds_float32(cascade_setup, monkeypatch):
    """TF32 allowed globally (cuDNN's default) is off inside the entry point
    and allowed again after it."""
    cfg, state = cascade_setup
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    infer = Infer(cfg, state, device="cpu")
    inside = []
    infer.net_g.upsample1.register_forward_pre_hook(lambda *_: inside.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    infer.sample_videos_np(next(story_batches(SyntheticStoryDataset(1), 1)))
    assert inside == [(False, False)]
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("key,value", [
    ("MESH_SHAPE", "data:4"), ("USE_PALLAS", True), ("REMAT", True), ("SCAN_STEPS", 1),
    ("BN_BACKEND", "pallas"), ("ADAM_MU_DTYPE", "bfloat16"),
])
def test_generator_refuses_keys_it_does_not_honour(key, value):
    cfg = config_from_file("final.yml").with_updates(GAN=TINY, **{key: value})
    with pytest.raises(NotImplementedError, match=key):
        generator_from_config(cfg)


def test_infer_without_a_card_raises(cascade_setup, monkeypatch):
    cfg, state = cascade_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Infer(cfg, state)


@pytest.mark.parametrize("name", ["final.yml", "cascade.yml", "throughput.yml", "procedural.yml"])
def test_config_matches_jax(name):
    jax_cfg = jax_config_from_file(str(ROOT / "cpcsv_tpu" / "configs" / name))
    assert dataclasses.asdict(config_from_file(name)) == dataclasses.asdict(jax_cfg)


def test_config_rejects_unknown_keys_and_types(tmp_path):
    bad = tmp_path / "bad.yml"
    bad.write_text("NOT_A_KEY: 1\n")
    with pytest.raises(KeyError, match="NOT_A_KEY"):
        config_from_file(str(bad))
    bad.write_text("VIDEO_LEN: five\n")
    with pytest.raises(ValueError, match="VIDEO_LEN"):
        config_from_file(str(bad))


def test_synthetic_stories_match_jax():
    ours, ref = SyntheticStoryDataset(4, seed=3), JaxSyntheticStoryDataset(4, seed=3)
    for i in (0, 3):
        for key, value in ref[i].items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(ours[i][key], value)
            else:
                assert ours[i][key] == value


def test_image_helpers_match_jax(tmp_path):
    frames = np.random.default_rng(6).uniform(-1.2, 1.2, (5, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.make_grid(frames, 3), jax_image.make_grid(frames, 3))
    image.save_png(frames[0], str(tmp_path / "ours.png"))
    jax_image.save_png(frames[0], str(tmp_path / "ref.png"))
    assert (tmp_path / "ours.png").read_bytes() == (tmp_path / "ref.png").read_bytes()


def _port_sources():
    return sorted((ROOT / "cpcsv_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "sweep_bn.py", ROOT / "bench_dfn.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "orbax", "cpcsv_tpu"), (
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"
            )
