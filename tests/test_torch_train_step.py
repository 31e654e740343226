"""The port's alternating D step and G step against the JAX package's.

One JAX `TrainState` (tiny widths, `final.yml` otherwise) is loaded into the
port's nets (`utils.weights.load_jax_train_state`); the same numpy batches
and the same noise (JAX's own draws, tapped while its step runs) go through
`cpcsv_tpu.train.steps.make_train_steps` and the port's. Compared: every
metric, every BN running statistic and SN u the step mutated, and the
gradients. JAX's gradients are recovered by replacing its Adam with the
identity transform, so that its update at lr = 1 is −g; the port leaves its
gradients in `.grad`.
"""

import collections
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpcsv_tpu
from cpcsv_tpu.config import GanConfig as JaxGanConfig
from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.losses import gan_losses as jax_losses
from cpcsv_tpu.models import build_models as jax_build_models
from cpcsv_tpu.train import create_train_state as jax_create_train_state
from cpcsv_tpu.train import make_train_steps as jax_make_train_steps
from cpcsv_tpu.utils.benchutil import synthetic_batches as jax_synthetic_batches
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import synthetic_batches
from cpcsv_tpu_torch.losses import gan_losses
from cpcsv_tpu_torch.ops import dynamic_filter
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.models.factory import build_models
from cpcsv_tpu_torch.train.state import create_train_state, make_adam
from cpcsv_tpu_torch.train.steps import make_train_steps
from cpcsv_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_jax_train_state,
)

TINY = dict(CONDITION_DIM=124, Z_DIM=100, DF_DIM=16, GF_DIM=8, GF_SEG_DIM=32)
B_ST, B_IM = 4, 4
KINDS = {"d_im": "image", "d_st": "story", "d_se": "seg"}
# Metrics, BN statistics and SN u: float32 on both sides, summed in other
# orders; they agree to ~1e-5 relative, 1e-3 leaves a margin.
TOL = dict(rtol=1e-3, atol=1e-4)
# Gradients, per tensor, in relative L2 norm. At these batches JAX's float32
# gradients differ from the port's by up to 2.5e-3. That is the reference's
# float32 error, not the port's: the port's float32 gradients match its own
# float64 run to ~1e-5, while at batches 2/3 the JAX package's two BN arms
# (BN_BACKEND xla and pallas) differed from each other by 1-4%. 1e-2 leaves a
# margin. A gradient that is 0 in exact arithmetic (a Linear bias before a
# train-mode BN) is held to 1e-2 x 1e-4 of the net's largest gradient norm instead.
GRAD_RTOL, GRAD_FLOOR = 1e-2, 1e-4


def configs():
    jcfg = jax_config_from_file(os.path.join(os.path.dirname(cpcsv_tpu.__file__), "configs",
                                             "final.yml"))
    return (jcfg.with_updates(GAN=JaxGanConfig(**TINY)),
            config_from_file("final.yml").with_updates(GAN=GanConfig(**TINY)))


def tapped(step):
    """The JAX step, jitted, returning its generator noise draws too (tapped
    from jax.random.normal while it traces)."""
    def fn(*args):
        draws, real = [], jax.random.normal

        def tap(key, shape=(), dtype=jnp.float32):
            x = real(key, shape, dtype)
            if sys._getframe(1).f_code.co_filename.endswith("models/generator.py"):
                draws.append(x)
            return x

        jax.random.normal = tap
        try:
            state, metrics = step(*args)
        finally:
            jax.random.normal = real
        return state, metrics, draws

    return jax.jit(fn)


@pytest.fixture(scope="module")
def run():
    """JAX state before, after its D step and after its G step (both from the
    state before), with their metrics and noise, and the batches."""
    jcfg, _ = configs()
    models = jax_build_models(jcfg)
    state0 = jax_create_train_state(jcfg, jax.random.PRNGKey(0), models)
    with mock.patch("cpcsv_tpu.train.steps.make_adam", lambda cfg=None: optax.identity()):
        d_step, g_step = jax_make_train_steps(jcfg, models, jit=False)
    st, im = synthetic_batches(configs()[1], B_ST, B_IM, seed=4)
    out = {}
    with jax.default_matmul_precision("highest"):
        for name, step, key in (("d", d_step, 1), ("g", g_step, 2)):
            out[name] = tapped(step)(state0, jax.random.PRNGKey(key), st, im, 1.0)
    to_np = lambda s: jax.tree.map(np.array, s)  # noqa: E731  writable host copies
    return to_np(state0), {k: to_np(v) for k, v in out.items()}, (st, im)


def port_step(run, which):
    state0, outs, (st, im) = run
    _, tcfg = configs()
    state = create_train_state(tcfg, seed=0, device="cpu")
    load_jax_train_state(state, state0)
    draws = outs[which][2]
    # 6 draws: story then image, each CA eps, motion-GRU h0, per-step noise
    assert [d.shape for d in draws] == [(B_ST, 124), (B_ST, 365), (B_ST, 5, 100),
                                        (B_IM, 124), (B_IM, 365), (B_IM, 1, 100)]
    noise = tuple(tuple(torch.from_numpy(d) for d in draws[i:i + 3]) for i in (0, 3))
    d_step, g_step = make_train_steps(tcfg)
    return (d_step if which == "d" else g_step)(state, noise, st, im, 4e-4)


def jax_state_dicts(state, grads_of=None):
    """Per net, the JAX state as the port's state_dict; with `grads_of` (the
    state before), the parameters replaced by before − after = the gradient."""
    out = {}
    for name in ("gen",) + tuple(KINDS):
        net = getattr(state, name)
        params = net.params
        if grads_of is not None:
            params = jax.tree.map(lambda a, b: a - b, getattr(grads_of, name).params, params)
        if name == "gen":
            out[name] = generator_state_dict_from_jax(
                {"params": params, "batch_stats": net.batch_stats})
        else:
            out[name] = discriminator_state_dict_from_jax(
                {"params": params, "batch_stats": net.batch_stats, "spectral": net.spectral},
                KINDS[name])
    return out


def close(ours, ref, what):
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    scale = float(np.abs(ref).max()) or 1.0
    np.testing.assert_allclose(ours, ref, rtol=TOL["rtol"], atol=TOL["atol"] * scale,
                               err_msg=what)


@pytest.mark.parametrize("which", ["d", "g"])
def test_step_metrics_state_and_gradients_match_jax(run, which):
    state0, outs, _ = run
    jax_after, jax_metrics, _ = outs[which]
    state, metrics = port_step(run, which)
    assert set(metrics) == set(jax_metrics)
    for tag, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[tag]), float(value), **TOL, err_msg=tag)

    after = jax_state_dicts(jax_after)
    grads = jax_state_dicts(jax_after, grads_of=state0)
    stepped = ("gen",) if which == "g" else tuple(KINDS)
    for name, net in state.nets().items():
        for key, buf in net.named_buffers():
            if key.endswith(("running_mean", "running_var", "weight_u")):
                close(buf, after[name][key], f"{which} step, {name}.{key}")
        if name not in stepped:
            assert all(p.grad is None for p in net.parameters()), f"{which} step changed {name}"
            continue
        ref = {key: np.asarray(grads[name][key]) for key, _ in net.named_parameters()}
        floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in ref.values())
        for key, p in net.named_parameters():
            err = np.linalg.norm(p.grad.numpy() - ref[key])
            assert err <= GRAD_RTOL * max(np.linalg.norm(ref[key]), floor), (
                f"{which} step, d {name}.{key}: error {err:.3e}, |ref| "
                f"{np.linalg.norm(ref[key]):.3e}")
    assert state.step == (1 if which == "g" else 0)


def test_mutated_state_moves(run):
    """Sanity of the comparison above: the JAX steps did move BN statistics
    and SN u of every net they run, so matching them is not trivial."""
    state0, outs, _ = run
    before = jax_state_dicts(state0)
    for which, nets in (("d", ("gen",) + tuple(KINDS)), ("g", ("gen",) + tuple(KINDS))):
        after = jax_state_dicts(outs[which][0])
        for name in nets:
            # (the 1-output head conv's u is ±1 whatever the step does)
            keys = [k for k in after[name] if k.endswith(("running_mean", "weight_u"))
                    and after[name][k].numel() > 1]
            assert keys and all(not np.array_equal(after[name][k], before[name][k])
                                for k in keys), (which, name)


def test_adam_matches_optax():
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    lrs = (4e-4, 1e-4, 2e-4)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_adam([param])
    tx = optax.scale_by_adam(b1=0.5, b2=0.999, eps=1e-8)
    ref, opt_state = jnp.asarray(p0), None
    opt_state = tx.init(ref)
    for g, lr in zip(grads, lrs):
        param.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        update, opt_state = tx.update(jnp.asarray(g), opt_state, ref)
        ref = ref - lr * update
        # float32 on both sides, the same formula in another operation order
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def _loss_inputs(rng, b):
    logits = lambda *s: (3 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    labels = (rng.random((b, 9)) < 0.4).astype(np.float32)
    return logits(b), logits(b - 1), logits(b), logits(b, 9), labels


@pytest.mark.parametrize("name,b", [
    ("bce_with_logits", 5), ("multilabel_soft_margin", 5), ("kl_loss", 5),
    ("multi_label_accuracy", 5), ("discriminator_loss", 5), ("discriminator_loss", 1),
    ("generator_loss", 5),
])
def test_losses_match_jax(name, b):
    rng = np.random.default_rng(b)
    real, wrong, fake, cate, labels = _loss_inputs(rng, b)
    args = {
        "bce_with_logits": (real, (rng.random(b) < 0.5).astype(np.float32)),
        "multilabel_soft_margin": (cate, labels),
        "kl_loss": (cate, cate[::-1].copy()),
        "multi_label_accuracy": (cate, labels),
        "discriminator_loss": (real, wrong, fake, cate, labels),
        "generator_loss": (fake, cate, labels),
    }[name]
    ours = getattr(gan_losses, name)(*(torch.from_numpy(a) for a in args))
    ref = getattr(jax_losses, name)(*(jnp.asarray(a) for a in args))
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for a, r in zip(ours, ref):
        # float32 elementwise math and means of a few terms
        np.testing.assert_allclose(float(a), float(r), rtol=1e-6, atol=1e-6)


def test_synthetic_batches_match_jax():
    jcfg, tcfg = configs()
    ours = synthetic_batches(tcfg, 2, 3, seed=9)
    ref = jax_synthetic_batches(jcfg, 2, 3, seed=9)
    for a, r in zip(ours, ref):
        assert set(a) == set(r)
        for key in r:
            np.testing.assert_array_equal(a[key], np.asarray(r[key]), err_msg=key)


@pytest.mark.parametrize("key,value", [
    ("CASCADE_MODEL", True), ("USE_SEQ_CONSISTENCY", True), ("SEGMENT_LEARNING", False),
    ("USE_INFONCE", True),
])
def test_build_models_refuses_what_the_slice_does_not_train(key, value):
    cfg = configs()[1].with_updates(**{key: value})
    with pytest.raises(NotImplementedError, match=key):
        build_models(cfg)


def test_create_train_state_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(configs()[1], seed=0)


def test_chip_smoke_launch_counts_match_a_step():
    """The per-step kernel launches that chip_smoke.py derives from the code
    equal the calls one CPU step makes to the kernels' plain versions."""
    import chip_smoke

    calls = collections.Counter()

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    _, tcfg = configs()
    state = create_train_state(tcfg, seed=1, device="cpu")
    d_step, g_step = make_train_steps(tcfg)
    st, im = synthetic_batches(tcfg, 2, 2, seed=1)
    rng = torch.Generator().manual_seed(1)
    with mock.patch.object(bn_cuda, "bn_stats_plain", counted("bn_stats", bn_cuda.bn_stats_plain)), \
            mock.patch.object(bn_cuda, "bn_grad_reduce_plain",
                              counted("bn_grad_reduce", bn_cuda.bn_grad_reduce_plain)), \
            mock.patch.object(dynamic_filter, "dynamic_filter_conv1d_plain", counted(
                "dfn_forward", dynamic_filter.dynamic_filter_conv1d_plain)):
        d_step(state, rng, st, im, 4e-4)
        g_step(state, rng, st, im, 1e-4)
    expected = chip_smoke.per_step_launches(state)
    assert dict(calls) == {k: v for k, v in expected.items() if k != "dfn_backward"}
