"""The port's serving entry point (`cpcsv_tpu_torch.evaluation.drivers.Infer`),
its config and synthetic stories against the JAX package's, and the rule
that the port imports nothing of JAX or of the JAX package."""

import ast
import dataclasses
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.data.synthetic import SyntheticStoryDataset as JaxSyntheticStoryDataset
from cpcsv_tpu.utils import image as jax_image
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import (
    SyntheticStoryDataset,
    story_batches,
    synthetic_batches,
)
from cpcsv_tpu_torch.evaluation.drivers import Infer
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.train.state import create_train_state
from cpcsv_tpu_torch.train.steps import make_train_steps
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


@pytest.mark.parametrize("key,value", [("MESH_SHAPE", "data"), ("MESH_SHAPE", "data:0")])
def test_generator_refuses_keys_it_does_not_honour(key, value):
    """A malformed MESH_SHAPE raises wherever the config is read; a
    well-formed one is honoured (`test_generator_and_infer_take_any_mesh`)."""
    cfg = config_from_file("final.yml").with_updates(GAN=TINY, **{key: value})
    with pytest.raises(ValueError, match=key):
        generator_from_config(cfg)


@pytest.mark.parametrize("mesh_shape", ["data:4", "data:4,model:2"])
def test_generator_and_infer_take_any_mesh(mesh_shape):
    """Serving and the walks accept any well-formed MESH_SHAPE and split
    their calls over its `data` axis on the local devices; on the CPU, one
    device, a larger mesh falls back to it with the JAX package's warning
    (`make_eval_mesh`; the split itself: `tests/test_torch_eval_mesh.py`);
    the models build under any mesh, and training holds the mesh to the
    process group (`mesh.check_training_mesh`), a model axis included."""
    from cpcsv_tpu_torch.models.factory import build_models
    from cpcsv_tpu_torch.parallel.mesh import check_training_mesh

    cfg = config_from_file("final.yml").with_updates(GAN=TINY, MESH_SHAPE=mesh_shape)
    with pytest.warns(UserWarning, match="falls back"):
        infer = Infer(cfg, device="cpu")
    assert infer.net_g is not None and infer.mesh == (torch.device("cpu"),)
    assert build_models(cfg)[0] is not None
    with pytest.raises(ValueError, match="but the run has 1 process"):
        check_training_mesh(cfg.MESH_SHAPE)


@functools.lru_cache(maxsize=None)
def tiny_step(**keys):
    """final.yml at this file's tiny widths with `keys`: one D+G step on the
    CPU from seed 0 with the same batches and noise, (state, metrics)."""
    cfg = config_from_file("final.yml").with_updates(
        GAN=GanConfig(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16), **keys)
    state = create_train_state(cfg, seed=0, device="cpu")
    st, im = synthetic_batches(cfg, 2, 4, seed=1)
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator().manual_seed(5)
    _, dm = d_step(state, rng, st, im, 4e-4)
    _, gm = g_step(state, rng, st, im, 1e-4)
    return state, {k: float(v) for k, v in {**dm, **gm}.items()}


@pytest.mark.parametrize("key,value", [
    ("USE_PALLAS", True), ("REMAT", True), ("SCAN_STEPS", 1), ("BN_BACKEND", "pallas"),
    ("ADAM_MU_DTYPE", "bfloat16"),
])
def test_lowering_keys_are_honoured(key, value):
    """The keys the port once refused, each flipped for one tiny D+G step
    against the default step, as its meaning says: USE_PALLAS (the DFN's
    kernel choice, the same function), SCAN_STEPS (the same updates one
    pair a dispatch), BN_BACKEND (the same BN arithmetic) and REMAT (the
    blocks recomputed) give the default's bits; ADAM_MU_DTYPE bfloat16 gives
    them too after one update (Adam uses the new first moment before it
    stores it) but for the stored first moments, the default's rounded to
    bfloat16. A BN_BACKEND the JAX package refuses raises as there
    (ADAM_MU_DTYPE's: `tests/test_torch_remat_adam.py`)."""
    ref_state, ref_metrics = tiny_step()
    state, metrics = tiny_step(**{key: value})
    assert metrics == ref_metrics
    for net, ref in zip(state.nets().values(), ref_state.nets().values()):
        for (name, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
            assert torch.equal(a, b), name
    mu = torch.bfloat16 if key == "ADAM_MU_DTYPE" else torch.float32
    for n, opt in state.opts.items():
        for a, b in zip(opt.state.values(), ref_state.opts[n].state.values()):
            assert a["exp_avg"].dtype == mu and torch.equal(a["exp_avg"], b["exp_avg"].to(mu))
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    if key == "BN_BACKEND":
        with pytest.raises(ValueError, match=key):
            generator_from_config(config_from_file("final.yml").with_updates(
                GAN=TINY, BN_BACKEND="cudnn"))


def test_infer_without_a_card_raises(cascade_setup, monkeypatch):
    cfg, state = cascade_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Infer(cfg, state)


@pytest.mark.parametrize("name", ["final.yml", "cascade.yml", "throughput.yml", "procedural.yml",
                                  "clevr.yml"])
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
