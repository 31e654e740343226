"""The port's walk pieces against the JAX package's on the CPU, on one
generator snapshot and the same test items.

The snapshot is a tiny cascade generator whose weights and BN statistics are
moved away from their init values (`test_torch_generator.perturb`), written
by the port's `CheckpointManager`. The port reads it with `Infer.load_epoch`,
the JAX package with its `port_generator_file`. The noise of every
generation is fixed to the same arrays on both sides, a function of the
draw's shape: the port's `draw_noise` is replaced, and the JAX generator's
`jax.random.normal` is tapped while its samplers trace (in fresh jits, so no
other test's cache sees the fixed noise).

Held: `generate_story` writes the same original/ and generate/ trees (real
frames the same PNG pixels, generated ones within one PNG level: the two
generators agree to 2e-3, as in `tests/test_torch_generator.py`); the SSIM
datasets pair the same real story with each generated one; and `eval_ssim`
gives the same score at 1e-3 relative. The JAX package's `Infer` is built
without its constructor, which would initialise a train state to restore
orbax snapshots into: only what its walks read is set.

And why the JAX package's SSIM record on a TPU (docs/procedural_run, 6.3 to
12.9 for trained checkpoints) lies above the formula's bound of 1 while the
port's SSIM does not: XLA on a TPU runs a float32 convolution at its default
precision as one pass of bfloat16 operands, and SSIM's variances are
differences of two such filtered sums. With the operands rounded to
bfloat16, the same formula reads above 1 on procedural frames against near
copies of them; in float32 it stays at most 1.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from cpcsv_tpu.evaluation import datasets as jax_datasets
from cpcsv_tpu.evaluation.drivers import Infer as JaxInfer
from cpcsv_tpu.models import generator_from_config as jax_generator_from_config
from cpcsv_tpu.utils.port_torch import port_generator_file, port_generator_state_dict
from cpcsv_tpu_torch.data.procedural import write_procedural_pororo
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset
from cpcsv_tpu_torch.evaluation import drivers, ssim
from cpcsv_tpu_torch.evaluation.datasets import StoryGANSSIMDataset
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.utils.weights import generator_state_dict_from_jax
from test_torch_generator import TOL, configs, perturb
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

EPOCH, STORIES, BATCH = 3, 4, 2


def fixed_noise(shape) -> np.ndarray:
    return np.random.default_rng(list(shape)).standard_normal(shape).astype(np.float32)


def pngs(root):
    """{story/frame: pixels} of a generate_story tree."""
    return {f"{s}/{f}": np.asarray(Image.open(os.path.join(root, s, f)), np.int16)
            for s in os.listdir(root) for f in os.listdir(os.path.join(root, s))}


@pytest.fixture(scope="module")
def walkers(tmp_path_factory):
    """(port Infer, JAX Infer, test items) on one snapshot, both generators'
    noise fixed."""
    jcfg, tcfg = configs(cascade=True)
    jcfg = jcfg.with_updates(CONFIG_NAME="walk")
    tcfg = tcfg.with_updates(CONFIG_NAME="walk")
    root = str(tmp_path_factory.mktemp("run"))
    torch.manual_seed(0)
    variables = perturb(port_generator_state_dict(
        generator_from_config(tcfg).state_dict(), use_segment=True, cascade=True), seed=60)
    CheckpointManager(os.path.join(root, "Model")).save_generator(
        generator_state_dict_from_jax(variables, use_segment=True, cascade=True), EPOCH)

    ours = drivers.Infer(tcfg, device="cpu", output_dir=root, load_ckpt=EPOCH)
    draw = ours.net_g.draw_noise
    ours.net_g.draw_noise = lambda batch, steps, generator=None: tuple(
        torch.from_numpy(fixed_noise(tuple(x.shape))) for x in draw(batch, steps, generator))

    ref = JaxInfer.__new__(JaxInfer)
    ref.cfg, ref.eval_dir, ref.mesh = jcfg, ours.eval_dir, None
    ref.net_g = jax_generator_from_config(jcfg)
    ref.rng, ref._shard_cache, ref._sample_jit = jax.random.PRNGKey(0), {}, {}
    ref._gen_vars = port_generator_file(
        os.path.join(root, "Model", f"netG_epoch_{EPOCH}.pth"), use_segment=True, cascade=True)
    data = SyntheticStoryDataset(STORIES, seed=4)
    return ours, ref, [data[i] for i in range(STORIES)]


@pytest.fixture
def jax_fixed_noise(monkeypatch):
    """The JAX generator's draws replaced by `fixed_noise` while its samplers
    trace; the StoryGAN datasets' sampler jitted anew, at float32."""
    real = jax.random.normal

    def tap(key, shape=(), dtype=jnp.float32):
        if sys._getframe(1).f_code.co_filename.endswith("models/generator.py"):
            return jnp.asarray(fixed_noise(tuple(shape)), dtype)
        return real(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", tap)
    monkeypatch.setattr(jax_datasets, "_sample_videos_jit",
                        jax.jit(jax_datasets._sample_videos_jit.__wrapped__, static_argnums=0))
    with jax.default_matmul_precision("highest"):
        yield


def test_generate_story_writes_the_jax_trees(walkers, jax_fixed_noise):
    ours, ref, items = walkers
    batches = [{k: np.stack([it[k] for it in items[i:i + BATCH]])
                for k in ("images", "description", "labels")}
               for i in range(0, STORIES, BATCH)]
    trees = [w.generate_story(batches, name) for w, name in ((ours, "port"), (ref, "jax"))]
    (orig, gen), (jax_orig, jax_gen) = (tuple(map(pngs, t)) for t in trees)
    assert sorted(gen) == sorted(jax_gen) == sorted(orig) == sorted(jax_orig)
    assert len(gen) == STORIES * 5
    for name in orig:
        np.testing.assert_array_equal(orig[name], jax_orig[name])
        assert np.abs(gen[name] - jax_gen[name]).max() <= 1, name
    # every generated frame its own, and far from flat
    assert len({frame.tobytes() for frame in gen.values()}) == len(gen)
    assert min(np.ptp(frame) for frame in gen.values()) > 20


def test_eval_ssim_pairs_and_scores_as_jax(walkers, jax_fixed_noise):
    ours, ref, items = walkers
    pairs = StoryGANSSIMDataset(ours.net_g, items, ours.generator)
    jax_pairs = jax_datasets.StoryGANSSIMDataset(ref.net_g, ref._gen_vars, items, ref.rng)
    for i in range(STORIES):
        (fake, real), (jax_fake, jax_real) = pairs[i], jax_pairs[i]
        np.testing.assert_array_equal(real, items[i]["images"])
        np.testing.assert_array_equal(real, jax_real)
        np.testing.assert_allclose(fake, jax_fake, **TOL)
    score = ours.eval_ssim(items, n=3)
    np.testing.assert_allclose(score, ref.eval_ssim(items, n=3), rtol=1e-3)
    assert 0 < abs(score) < 1


def ssim_of_bf16_operands(img1, img2):
    """The SSIM formula with every convolution operand (the images, their
    products and the window) rounded to bfloat16, the sums in float32."""
    a, b = (torch.from_numpy(x).movedim(-1, 1) for x in (img1, img2))
    window = torch.from_numpy(ssim._gaussian_window()).expand(3, 1, 11, 11)
    bf16 = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    filt = lambda x: F.conv2d(bf16(x), bf16(window), padding=5, groups=3)  # noqa: E731
    mu1, mu2 = filt(a), filt(b)
    var1, var2, cov = filt(a * a) - mu1 ** 2, filt(b * b) - mu2 ** 2, filt(a * b) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return float((((2 * mu1 * mu2 + c1) * (2 * cov + c2))
                  / ((mu1 ** 2 + mu2 ** 2 + c1) * (var1 + var2 + c2))).mean())


def test_ssim_exceeds_one_only_with_bf16_operands(tmp_path):
    write_procedural_pororo(str(tmp_path), n_episodes=1, frames_per_episode=5)
    episode = tmp_path / "ep000"
    real = np.stack([np.asarray(Image.open(episode / f"{t + 1}.png").convert("RGB"),
                                np.float32)[:64] / 127.5 - 1 for t in range(5)])
    noisy = np.clip(real + np.random.default_rng(0).normal(0, 0.02, real.shape), -1, 1)
    for fake in (np.float32(0.9) * real, noisy.astype(np.float32)):
        exact = float(ssim.ssim(torch.from_numpy(fake), torch.from_numpy(real)))
        assert 0.5 < exact <= 1
        assert ssim_of_bf16_operands(fake, real) > 1
