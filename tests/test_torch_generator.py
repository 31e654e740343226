"""The port's eval-mode generator against the JAX package's.

Same weights (JAX variables converted by
`cpcsv_tpu_torch.utils.weights.generator_state_dict_from_jax`), same inputs
(numpy, from a seed) and the same noise (JAX's own draws, tapped during its
forward) go through both. The BN running statistics and scales are moved
away from 0 / 1 / 1 first, or eval BN would be the identity and prove
nothing; the kernels are rescaled so that the frames are far from 0. Tiny
widths (GF_DIM=8, GF_SEG_DIM=32) keep this file fast on a CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpcsv_tpu
from cpcsv_tpu.config import GanConfig as JaxGanConfig
from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.models import generator_from_config as jax_generator_from_config
from cpcsv_tpu.ops import blocks as jax_blocks
from cpcsv_tpu.utils.export_torch import export_generator_variables
from cpcsv_tpu.utils.port_torch import port_generator_file, port_generator_state_dict
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.ops import blocks
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.utils.weights import generator_state_dict_from_jax
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

B, T, TEXT, MOTION, COND, NOISE = 3, 5, 356, 365, 124, 100
TINY = dict(CONDITION_DIM=124, Z_DIM=100, DF_DIM=16, GF_DIM=8, GF_SEG_DIM=32)
# the replica tolerance of tests/test_port_torch.py: float32 on both sides,
# the convolutions and dense layers sum in different orders
TOL = dict(rtol=2e-3, atol=2e-3)


def perturb(variables, seed):
    """Kernels ~ N(0, 1/fan_in) so every layer keeps its input's scale (flax's
    N(0, 0.02) init leaves the tiny model's frames near 0, inside any
    tolerance); BN running mean ~ N(0, 0.3), running var ~ U(0.5, 2),
    scale ~ 1 + N(0, 0.3), bias ~ N(0, 0.1), away from their init values."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for key, sub in params.items():
            if key == "kernel":
                fan_in = int(np.prod(sub.shape[:-1]))
                params[key] = rng.normal(0, fan_in ** -0.5, sub.shape).astype(np.float32)
            elif isinstance(sub, dict):
                walk(sub, (stats or {}).get(key))
        if stats is not None and "mean" in stats and not isinstance(stats["mean"], dict):
            shape = stats["mean"].shape
            stats["mean"] = rng.normal(0, 0.3, shape).astype(np.float32)
            stats["var"] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
            params["scale"] = (1 + rng.normal(0, 0.3, shape)).astype(np.float32)
            params["bias"] = rng.normal(0, 0.1, shape).astype(np.float32)

    out = jax.tree.map(np.array, variables)  # writable host copies
    walk(out["params"], out["batch_stats"])
    return out


def configs(cascade, quirk=False):
    name = "cascade.yml" if cascade else "final.yml"
    extra = dict(TORCH_REPEAT_QUIRK=quirk)
    jcfg = jax_config_from_file(os.path.join(os.path.dirname(cpcsv_tpu.__file__), "configs", name))
    tcfg = config_from_file(name)
    return (jcfg.with_updates(GAN=JaxGanConfig(**TINY), **extra),
            tcfg.with_updates(GAN=GanConfig(**TINY), **extra))


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "cascade"])
def variant(request):
    """(cascade, JAX variables with moved BN, port generator loaded with them).
    The variables' tree comes from a port generator through the JAX package's
    own converter (`port_generator_state_dict`), cheaper than tracing flax's
    init; perturb then draws every kernel and BN value anew."""
    cascade = request.param
    _, tcfg = configs(cascade)
    net = generator_from_config(tcfg)
    variables = port_generator_state_dict(net.state_dict(), use_segment=True, cascade=cascade)
    variables = perturb(variables, seed=10 + cascade)
    net.load_state_dict(
        generator_state_dict_from_jax(variables, use_segment=True, cascade=cascade),
        strict=True,
    )
    return cascade, variables, net.eval()


_SAMPLERS = {}  # (JAX config, method) -> its jitted sampler, traced once


def jax_sample(jcfg, variables, method, motion, content, key):
    """The JAX generator of `jcfg` in eval mode, jitted once per (config,
    method), returning (image, seg, noise draws). The draws are tapped from
    jax.random.normal while the sampler traces; only those made by the
    generator module count (flax also calls the BN scale initialiser under
    eval_shape to check parameter shapes)."""
    if (jcfg, method) not in _SAMPLERS:
        gen, real = jax_generator_from_config(jcfg), jax.random.normal

        def fn(variables, motion, content, key):
            draws = []

            def tap(key, shape=(), dtype=jnp.float32):
                x = real(key, shape, dtype)
                if sys._getframe(1).f_code.co_filename.endswith("models/generator.py"):
                    draws.append(x)
                return x

            jax.random.normal = tap
            try:
                out = gen.apply(variables, motion, content, True, False,
                                method=method, rngs={"noise": key})
            finally:
                jax.random.normal = real
            return out.image, out.seg, draws

        _SAMPLERS[jcfg, method] = jax.jit(fn)
    with jax.default_matmul_precision("highest"):
        image, seg, noise = _SAMPLERS[jcfg, method](variables, motion, content, key)
    return np.asarray(image), np.asarray(seg), [np.array(d) for d in noise]


def test_weights_match_export_and_load_strict(variant):
    cascade, variables, net = variant
    ours = generator_state_dict_from_jax(variables, use_segment=True, cascade=cascade)
    ref = export_generator_variables(variables, use_segment=True, cascade=cascade)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)
    assert set(ours) == set(net.state_dict())


@pytest.mark.parametrize("quirk", [False, True], ids=["repeat", "tile"])
def test_sample_videos_matches_jax(variant, quirk):
    cascade, variables, net = variant
    jcfg, _ = configs(cascade, quirk)
    net.torch_repeat_quirk = quirk
    rng = np.random.default_rng(20 + 2 * cascade + quirk)
    motion = rng.standard_normal((B, T, MOTION)).astype(np.float32)
    content = rng.standard_normal((B, T, TEXT)).astype(np.float32)

    image, seg, draws = jax_sample(jcfg, variables, "sample_videos", motion, content,
                                   jax.random.PRNGKey(7))
    # draw order: CA eps, motion-GRU h0, per-step noise
    assert [d.shape for d in draws] == [(B, COND), (B, MOTION), (B, T, NOISE)]
    with torch.no_grad():
        out = net.sample_videos(
            torch.from_numpy(motion), torch.from_numpy(content), seg=True,
            noise=tuple(torch.from_numpy(d) for d in draws),
        )
    assert out.image.shape == (B, T, 64, 64, 3)
    np.testing.assert_allclose(out.image.numpy(), image, **TOL)
    np.testing.assert_allclose(out.seg.numpy(), seg, **TOL)


def test_sample_images_matches_jax(variant):
    cascade, variables, net = variant
    jcfg, _ = configs(cascade)
    net.torch_repeat_quirk = False
    rng = np.random.default_rng(30 + cascade)
    motion = rng.standard_normal((B, MOTION)).astype(np.float32)
    content = rng.standard_normal((B, T, TEXT)).astype(np.float32)

    image, seg, draws = jax_sample(jcfg, variables, "sample_images", motion, content,
                                   jax.random.PRNGKey(9))
    assert [d.shape for d in draws] == [(B, COND), (B, MOTION), (B, 1, NOISE)]
    with torch.no_grad():
        out = net.sample_images(
            torch.from_numpy(motion), torch.from_numpy(content), seg=True,
            noise=tuple(torch.from_numpy(d) for d in draws),
        )
    assert out.image.shape == (B, 64, 64, 3)
    np.testing.assert_allclose(out.image.numpy(), image, **TOL)
    np.testing.assert_allclose(out.seg.numpy(), seg, **TOL)


def test_jax_package_samples_a_port_snapshot_as_the_port_does(variant, tmp_path):
    """A generator snapshot as the port's trainer writes it
    (`CheckpointManager.save_generator`, netG_epoch_0.pth) read by the JAX
    package's `port_generator_file`: the same variables, and its eval-mode
    sample_videos from them, with JAX's noise injected into a port generator
    loaded from the same file, gives the same frames and masks."""
    cascade, variables, net = variant
    jcfg, tcfg = configs(cascade)
    CheckpointManager(str(tmp_path)).save_generator(net.state_dict(), 0)
    path = str(tmp_path / "netG_epoch_0.pth")
    ported = port_generator_file(path, use_segment=True, cascade=cascade)
    assert jax.tree.structure(ported) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(ported), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(50 + cascade)
    motion = rng.standard_normal((B, T, MOTION)).astype(np.float32)
    content = rng.standard_normal((B, T, TEXT)).astype(np.float32)
    image, seg, draws = jax_sample(jcfg, ported, "sample_videos", motion, content,
                                   jax.random.PRNGKey(11))
    loaded = generator_from_config(tcfg)
    loaded.load_state_dict(torch.load(path, weights_only=True), strict=True)
    with torch.no_grad():
        out = loaded.eval().sample_videos(
            torch.from_numpy(motion), torch.from_numpy(content), seg=True,
            noise=tuple(torch.from_numpy(d) for d in draws))
    np.testing.assert_allclose(out.image.numpy(), image, **TOL)
    np.testing.assert_allclose(out.seg.numpy(), seg, **TOL)


@pytest.mark.parametrize("kind", ["up_off", "up_deconv", "down", "dense"])
def test_blocks_match_flax(kind):
    rng = np.random.default_rng(40)
    if kind == "dense":
        x = rng.standard_normal((4, 24)).astype(np.float32)
        flax_mod = jax_blocks.DenseBN(16, activation=jnp.tanh)
        port = blocks.DenseBN(24, 16, torch.nn.Tanh())
    else:
        x = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)  # NHWC
        if kind == "down":
            flax_mod = jax_blocks.DownBlock(5)
            port = blocks.DownBlock(6, 5)
        else:
            fused = kind.split("_")[1]
            flax_mod = jax_blocks.UpBlock(5, fused=fused)
            port = blocks.UpBlock(6, 5, fused)
    variables = perturb(jax.jit(flax_mod.init, static_argnums=2)(
        jax.random.PRNGKey(1), jnp.asarray(x), False), 41)
    p, s = variables["params"], variables["batch_stats"]
    sd = {}
    if kind == "dense":
        sd["0.weight"] = p["dense"]["kernel"].T
        sd["0.bias"] = p["dense"]["bias"]
        i_bn = 1
    elif kind == "down":
        sd["0.weight"] = p["conv"]["kernel"].transpose(3, 2, 0, 1)
        sd["0.bias"] = p["conv"]["bias"]
        i_bn = 1
    else:
        sd["1.weight"] = p["conv"]["kernel"].transpose(3, 2, 0, 1)
        i_bn = 2
    sd[f"{i_bn}.weight"], sd[f"{i_bn}.bias"] = p["bn"]["scale"], p["bn"]["bias"]
    sd[f"{i_bn}.running_mean"], sd[f"{i_bn}.running_var"] = s["bn"]["mean"], s["bn"]["var"]
    sd[f"{i_bn}.num_batches_tracked"] = np.array(0)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    port.eval()

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(flax_mod.apply, static_argnums=2)(variables, jnp.asarray(x),
                                                                   False))
    xt = torch.from_numpy(x if kind == "dense" else x.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        y = port(xt).numpy()
    if kind != "dense":
        y = y.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(y, ref, rtol=1e-4, atol=1e-4)

    # train mode: batch statistics, and the running statistics updated
    port.train()
    with jax.default_matmul_precision("highest"):
        ref, mut = jax.jit(lambda v, x: flax_mod.apply(v, x, True, mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        y = port(xt).numpy()
    if kind != "dense":
        y = y.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-4, atol=1e-4)
    bn = port[i_bn]
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["bn"]["mean"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["bn"]["var"],
                               rtol=1e-4, atol=1e-5)
