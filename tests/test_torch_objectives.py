"""The port's remaining training objectives against the JAX package's: the
order-consistency VideoEncoder (`USE_SEQ_CONSISTENCY`), InfoNCE
(`USE_INFONCE`, `INFONCE_TEMPERATURE`) and the plain generator without a seg
D (`SEGMENT_LEARNING: false`), at tiny GAN widths (the VideoEncoder has no
width key: it runs at its published channels on 2-4 stories).

  * the VideoEncoder alone, train and eval mode, forward and backward, its
    weights carried JAX -> port -> JAX (`utils/weights.py`,
    `cpcsv_tpu/utils/port_torch.py`, `export_torch.py`);
  * the host shuffle, bit for bit; the extended losses; the gradient penalty;
  * one D step and one G step of each variant from one state, batches and
    noise, against `cpcsv_tpu/train/steps.py`, as
    `tests/test_torch_train_step.py` compares final.yml's: metrics, every
    BN running statistic and SN u, the stepped nets' gradients; and the
    kernels' calls a step against `chip_smoke.per_step_launches`;
  * a seq-consistency step at COMPUTE_DTYPE bfloat16, held as the cascade's
    bf16 steps are in `tests/test_torch_train_step.py` (within twice the JAX
    package's own bf16 spreads);
  * the CLI: a seq-consistency YAML trained and auto-resumed bitwise, and a
    SEGMENT_LEARNING: false run with no netD_se file, served by `Infer`.
"""

import collections
import copy
import dataclasses
import functools
import gc
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

import chip_smoke
from cpcsv_tpu.losses import gan_losses as jax_losses
from cpcsv_tpu.losses.gradient_penalty import gradient_penalty as jax_gradient_penalty
from cpcsv_tpu.losses.shuffle import create_random_shuffle as jax_create_random_shuffle
from cpcsv_tpu.models import build_models as jax_build_models
from cpcsv_tpu.models.video_encoder import VideoEncoder as JaxVideoEncoder
from cpcsv_tpu.train import make_train_steps as jax_make_train_steps
from cpcsv_tpu.train.state import NetState as JaxNetState
from cpcsv_tpu.train.state import TrainState as JaxTrainState
from cpcsv_tpu.utils.export_torch import export_video_encoder_variables
from cpcsv_tpu.utils.port_torch import (
    port_discriminator_state_dict,
    port_generator_state_dict,
    port_video_encoder_state_dict,
)
from cpcsv_tpu_torch.cli import main_pororo
from cpcsv_tpu_torch.config import config_from_file
from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches, synthetic_batches
from cpcsv_tpu_torch.evaluation.drivers import Infer
from cpcsv_tpu_torch.losses import gan_losses
from cpcsv_tpu_torch.losses.gradient_penalty import gradient_penalty
from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle
from cpcsv_tpu_torch.models.factory import build_models, generator_from_config
from cpcsv_tpu_torch.models.video_encoder import VideoEncoder
from cpcsv_tpu_torch.ops import batchnorm, blocks, dynamic_filter
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.train.state import create_train_state, weights_init
from cpcsv_tpu_torch.train import steps as steps_module
from cpcsv_tpu_torch.train.steps import make_train_steps
from cpcsv_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_jax_train_state,
    video_encoder_state_dict_from_jax,
)
from test_torch_train_step import B_IM, B_ST, GRAD_FLOOR, GRAD_RTOL, TOL, close, configs, tapped
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

# variant -> the keys flipped in final.yml
VARIANTS = {
    "seq": dict(USE_SEQ_CONSISTENCY=True),
    "infonce": dict(USE_INFONCE=True, INFONCE_TEMPERATURE=0.5),
    "noseg": dict(SEGMENT_LEARNING=False),
}
KINDS = {"d_im": "image", "d_st": "story", "d_se": "seg"}
SHUFFLE_SEED = 7  # at B_ST = 4 it shuffles two stories of the four, one with a partner frame
# The seq-consistency G step backpropagates through the VideoEncoder's eleven
# train-mode BNs over 4 stories into the generator: against a float64 run of
# the port, the port's float32 generator gradients lie up to 8.0e-3 off and
# the JAX package's 8.8e-3 (largest at upsample3/4's BN scales), so the two
# float32 steps differ by ~1.1e-2, float32's error either side;
# `test_seq_g_gradients_hold_against_float64` checks both. A wrong term
# moves a gradient by O(1).
GRAD_RTOL_SEQ_G = 3e-2
GRAD_RTOL_SEQ_G_FLOAT64 = 1.5e-2  # the port's float32 seq G gradients against its float64 run


def variant_configs(variant, **more):
    jcfg, tcfg = configs("final.yml")
    return jcfg.with_updates(**VARIANTS[variant], **more), tcfg.with_updates(**VARIANTS[variant],
                                                                              **more)


def variant_batches(tcfg):
    """The numpy batches of both steps; with USE_SEQ_CONSISTENCY the story
    batch carries the host shuffle, as the trainers add it."""
    st, im = synthetic_batches(tcfg, B_ST, B_IM, seed=4)
    if tcfg.USE_SEQ_CONSISTENCY:
        shuffled, labels = create_random_shuffle(
            st["images"], rng=np.random.default_rng(SHUFFLE_SEED))
        assert 0 < labels.sum() < B_ST
        st = {**st, "shuffled": shuffled, "order_labels": labels}
    return st, im


# ------------------------------------------------------------ VideoEncoder

def _ve_inputs(B=3, seed=2):
    rng = np.random.default_rng(seed)
    story = np.tanh(rng.standard_normal((B, 5, 64, 64, 3))).astype(np.float32)
    return story, rng.standard_normal((B, 1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ve_jax(train):
    def run(variables, story, w):
        def loss(params, x):
            out, mut = JaxVideoEncoder().apply(
                {**variables, "params": params}, x, train=train,
                mutable=["batch_stats", "spectral"] if train else [])
            return jnp.sum(out * w), (out, mut)
        (_, (out, mut)), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            variables["params"], story)
        return out, mut, grads

    return jax.jit(run)


def _port_grads(net, story, w, dtype, train=True):
    """(d story, {name: d parameter}) of sum(VideoEncoder(story) * w) on a
    copy of `net` in `dtype` (the plain kernels take any dtype; the float32
    guard of train-mode BN is lifted)."""
    x = torch.from_numpy(story).to(dtype).requires_grad_()
    copied = VideoEncoder().to(dtype).train(train)
    copied.load_state_dict(net.state_dict())  # (a deep copy fails after an SN forward)
    with mock.patch.object(blocks, "batch_norm_train", batchnorm._BatchNormTrain.apply):
        out = copied(x)
    (out * torch.from_numpy(w).to(dtype)).sum().backward()
    return x.grad.double().numpy(), {k: p.grad.double().numpy()
                                     for k, p in copied.named_parameters()}


def _rel(a, ref):
    return np.linalg.norm(np.asarray(a, np.float64) - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_video_encoder_matches_jax(train):
    """From the port's init, through the JAX package's converter: the order
    logits, the gradients of the parameters and of the stories, and in train
    mode the BN running statistics and SN u it moved; the JAX result comes
    back through `utils/weights.py` and loads strictly. Twice in train mode,
    so that the second call runs from the state the first left.

    Gradients in relative L2 per tensor, the step tests' bound and floor
    (detector.0's bias, before a train-mode BN, has a gradient of 0 in exact
    arithmetic). Where the JAX package's gradient misses it, the port's
    float64 run decides: the port's float32 gradient must lie within 1e-4 of
    it and JAX's beyond the bound (in eval mode JAX's gradient of the first
    body BN's bias lies 0.44 from float64, every other tensor ~1e-6)."""
    net = VideoEncoder()
    weights_init(net, torch.Generator().manual_seed(5))
    net.train(train)
    variables = jax.tree.map(np.array, port_video_encoder_state_dict(net.state_dict()))
    story, w = _ve_inputs()
    for _ in range(2 if train else 1):
        exact = functools.lru_cache()(lambda: _port_grads(net, story, w, torch.float64, train)[1])
        with jax.default_matmul_precision("highest"):
            out_ref, mut, (g_params, g_story) = _ve_jax(train)(variables, story, w)
        x = torch.from_numpy(story).requires_grad_()
        for p in net.parameters():
            p.grad = None
        out = net(x)
        (out * torch.from_numpy(w)).sum().backward()
        assert out.shape == (3, 1)
        close(out, out_ref, "order logits")
        # through eleven train-mode BNs over 3 stories JAX's float32 input
        # gradient lies ~1e-3 from float64 (the port's ~1e-5, held below)
        g_story = np.asarray(g_story)
        assert (np.linalg.norm(x.grad.numpy() - g_story)
                <= GRAD_RTOL * np.linalg.norm(g_story)), "d story"
        mut = jax.tree.map(np.array, mut)
        variables = {**variables, **mut}
        after = video_encoder_state_dict_from_jax(variables)
        grads = video_encoder_state_dict_from_jax({**variables, "params": g_params})
        VideoEncoder().load_state_dict(after, strict=True)
        floor = GRAD_FLOOR * max(np.linalg.norm(grads[k].numpy()) for k, _ in
                                 net.named_parameters())
        jax_off = []
        for key, p in net.named_parameters():
            ref = grads[key].numpy()
            bound = GRAD_RTOL * max(np.linalg.norm(ref), floor)
            if np.linalg.norm(p.grad.numpy() - ref) <= bound:
                continue
            assert _rel(p.grad.numpy(), exact()[key]) <= 1e-4, key
            assert np.linalg.norm(ref - exact()[key]) > bound, key
            jax_off.append(key)
        print(f"VideoEncoder {'train' if train else 'eval'}: JAX's gradients off float64 at "
              f"{jax_off}")
        for key, buf in net.named_buffers():
            if key.endswith(("running_mean", "running_var", "weight_u")):
                close(buf, after[key], key)


def test_video_encoder_gradient_holds_against_float64():
    """The ground for comparing the stories' gradient in relative L2 above:
    the port's float32 train-mode VideoEncoder against its own float64 run,
    and the JAX package's float32 one against the same."""
    net = VideoEncoder()
    weights_init(net, torch.Generator().manual_seed(5))
    variables = jax.tree.map(np.array, port_video_encoder_state_dict(net.state_dict()))
    story, w = _ve_inputs()
    with jax.default_matmul_precision("highest"):
        _, _, (_, g_jax) = _ve_jax(True)(variables, story, w)
    exact = _port_grads(net, story, w, torch.float64)[0]
    port, ref = _rel(_port_grads(net, story, w, torch.float32)[0], exact), _rel(g_jax, exact)
    print(f"VideoEncoder d story against float64, relative L2: port float32 {port:.3e}, "
          f"JAX float32 {ref:.3e}")
    assert port <= 1e-4 and ref <= GRAD_RTOL


def test_video_encoder_weights_round_trip_through_the_jax_exporter():
    """JAX variables -> port (`utils/weights.py`) equals the JAX package's own
    torch export (`export_video_encoder_variables`), weight_v included, and
    the port's state_dict goes back to the same JAX variables."""
    net = VideoEncoder()
    variables = jax.tree.map(np.array, port_video_encoder_state_dict(net.state_dict()))
    ours = video_encoder_state_dict_from_jax(variables, "seq_consisten_model.")
    ref = export_video_encoder_variables(variables, "seq_consisten_model.")
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), value, rtol=1e-6, atol=1e-7, err_msg=key)
    back = port_video_encoder_state_dict(video_encoder_state_dict_from_jax(variables))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(np.asarray(a), b)


# ---------------------------------------------------- shuffle and losses

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shuffle_is_bit_equal_to_jax(seed):
    stories = np.random.default_rng(100 + seed).standard_normal((6, 5, 4, 4, 3)).astype(np.float32)
    ours_rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    ours, ref = create_random_shuffle(stories, rng=ours_rng), jax_create_random_shuffle(
        stories, rng=ref_rng)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_array_equal(ours[1], ref[1])
    assert ours[1].dtype == np.float32 and ours_rng.random() == ref_rng.random()


def _objective_args(rng, b):
    logits = lambda *s: (2 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    labels = (rng.random((b, 9)) < 0.4).astype(np.float32)
    order_labels = (rng.random(b) < 0.5).astype(np.float32)
    return {
        "infonce_loss": ((logits(b, b),), dict(temperature=0.5)),
        "discriminator_loss_order": ((logits(b), logits(b - 1), logits(b), None, None,
                                      logits(b, 1), order_labels, 0.7), {}),
        "discriminator_loss_pair": ((logits(b), None, logits(b), logits(b, 9), labels),
                                    dict(pair_logits=logits(b, b), infonce_temperature=2.0)),
        "generator_loss_consistency": ((logits(b), None, None, logits(b, 1), logits(b, 1), 1.5),
                                       {}),
    }


@pytest.mark.parametrize("name", ["infonce_loss", "discriminator_loss_order",
                                  "discriminator_loss_pair", "generator_loss_consistency"])
def test_objective_losses_match_jax(name):
    args, kwargs = _objective_args(np.random.default_rng(3), 5)[name]
    fn = name.split("_loss")[0] + "_loss"

    def to(convert, a):
        return convert(a) if isinstance(a, np.ndarray) else a

    ours = getattr(gan_losses, fn)(*(to(torch.from_numpy, a) for a in args),
                                   **{k: to(torch.from_numpy, v) for k, v in kwargs.items()})
    ref = getattr(jax_losses, fn)(*(to(jnp.asarray, a) for a in args),
                                  **{k: to(jnp.asarray, v) for k, v in kwargs.items()})
    ours = ours if isinstance(ours, tuple) else (ours,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(ours) == len(ref)
    for a, r in zip(ours, ref):
        # float32 elementwise math, softmaxes and means of a few terms
        np.testing.assert_allclose(float(a), float(r), rtol=1e-6, atol=1e-6)
    # the new term is in: the InfoNCE, the order BCE, the pair InfoNCE in the
    # wrong slot, the consistency MSE
    new = {"infonce_loss": 0, "discriminator_loss_order": 5, "discriminator_loss_pair": 2,
           "generator_loss_consistency": 2}[name]
    assert float(ours[new]) > 0


def test_consistency_mse_takes_no_gradient_through_the_real_side():
    fake, real = (torch.randn(4, 1, requires_grad=True) for _ in range(2))
    out = gan_losses.generator_loss(torch.randn(4), None, None, fake, real, 1.0)
    out.total.backward()
    assert real.grad is None and fake.grad is not None


def test_gradient_penalty_matches_jax():
    """A critic without BN (tanh of a linear map): the penalty and its
    gradient in the critic's weights (a double backward) against
    `cpcsv_tpu/losses/gradient_penalty.py` with the same α."""
    rng = np.random.default_rng(11)
    real, fake = (rng.standard_normal((4, 3, 8, 8)).astype(np.float32) for _ in range(2))
    w1, w2 = rng.standard_normal((192, 16)).astype(np.float32), rng.standard_normal(16).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    alpha = np.array(jax.random.uniform(key, (4, 1, 1, 1), jnp.float32))

    def jax_gp(w1):
        critic = lambda x: jnp.tanh(x.reshape(4, -1) @ w1) @ w2  # noqa: E731
        return jax_gradient_penalty(critic, jnp.asarray(real), jnp.asarray(fake), key)

    with jax.default_matmul_precision("highest"):
        ref, g_ref = jax.jit(jax.value_and_grad(jax_gp))(jnp.asarray(w1))
    tw1 = torch.from_numpy(w1).requires_grad_()
    critic = lambda x: torch.tanh(x.reshape(4, -1) @ tw1) @ torch.from_numpy(w2)  # noqa: E731
    gp = gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                          alpha=torch.from_numpy(alpha))
    gp.backward()
    # float32, sums of 192 products in other orders, twice differentiated
    np.testing.assert_allclose(float(gp.detach()), float(ref), rtol=1e-5)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(tw1.grad.numpy(), g_ref, rtol=1e-4,
                               atol=1e-5 * np.abs(g_ref).max())
    # drawn α: a penalty, finite, from a generator
    drawn = gradient_penalty(critic, torch.from_numpy(real), torch.from_numpy(fake),
                             generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)


# ------------------------------------------------------------ factory

def test_build_models_builds_each_variant():
    for variant in VARIANTS:
        tcfg = variant_configs(variant)[1]
        net_g, d_im, d_st, d_se = build_models(tcfg)
        assert (d_se is None) == (not tcfg.SEGMENT_LEARNING), variant
        assert net_g.use_segment == tcfg.SEGMENT_LEARNING
        assert (d_st.seq_consisten_model is not None) == tcfg.USE_SEQ_CONSISTENCY, variant
        generator_from_config(tcfg)  # INFONCE_TEMPERATURE, any value, is accepted


# ------------------------------------------------------- the train steps

def jax_state_from_port(state, tx):
    """The port's TrainState as the JAX package's, through its converter;
    d_se None where the port has none."""
    def net_state(variables):
        variables = jax.tree.map(np.array, variables)
        return JaxNetState(params=variables["params"], batch_stats=variables["batch_stats"],
                           spectral=variables.get("spectral", {}),
                           opt_state=tx.init(variables["params"]))

    def d(name):
        net = getattr(state, name)
        return None if net is None else net_state(
            port_discriminator_state_dict(net.state_dict(), KINDS[name]))

    return JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        gen=net_state(port_generator_state_dict(state.gen.state_dict(),
                                                use_segment=state.gen.use_segment)),
        d_im=d("d_im"), d_st=d("d_st"), d_se=d("d_se"))


def jax_state_dicts(state, grads_of=None, use_segment=True):
    """Per net, the JAX state as the port's state_dict; with `grads_of` (the
    state before), the parameters replaced by before − after = the gradient."""
    out = {}
    for name in ("gen",) + tuple(KINDS):
        net = getattr(state, name)
        if net is None:
            continue
        params = net.params
        if grads_of is not None:
            params = jax.tree.map(lambda a, b: a - b, getattr(grads_of, name).params, params)
        if name == "gen":
            out[name] = generator_state_dict_from_jax(
                {"params": params, "batch_stats": net.batch_stats}, use_segment=use_segment)
        else:
            out[name] = discriminator_state_dict_from_jax(
                {"params": params, "batch_stats": net.batch_stats, "spectral": net.spectral},
                KINDS[name])
    return out


@functools.lru_cache(maxsize=None)
def port_init(variant, dtype="float32"):
    """The port's initial TrainState of a variant (seed 0); callers step a deep copy."""
    return create_train_state(variant_configs(variant, COMPUTE_DTYPE=dtype)[1], seed=0,
                              device="cpu")


def _jax_steps(jcfg, state0, st, im, which=("d", "g")):
    """The JAX D and G steps (Adam replaced by the identity, lr 1) from
    state0, each traced once: {which: (state, metrics, noise draws)}."""
    with mock.patch("cpcsv_tpu.train.steps.make_adam", lambda cfg=None: optax.identity()):
        d_step, g_step = jax_make_train_steps(jcfg, jax_build_models(jcfg), jit=False)
    out = {}
    gc.disable()  # the collector's passes over a trace's short-lived objects
    try:
        with jax.default_matmul_precision("highest"):
            for w in which:
                step, key = (d_step, 1) if w == "d" else (g_step, 2)
                out[w] = jax.tree.map(np.array, tapped(step)(state0, jax.random.PRNGKey(key),
                                                             st, im, 1.0))
    finally:
        gc.enable()
    return out


RUNS = {}  # variant -> (JAX state before as numpy, {which: JAX result}, batches)


def variant_run(variant):
    if variant not in RUNS:
        jcfg, tcfg = variant_configs(variant)
        state0 = jax.tree.map(np.array, jax_state_from_port(port_init(variant),
                                                            optax.identity()))
        st, im = variant_batches(tcfg)
        RUNS[variant] = state0, _jax_steps(jcfg, state0, st, im), (st, im)
    return RUNS[variant]


def noise_of(draws):
    """JAX's six generator draws as the port's (story, image) noise: CA eps,
    motion-GRU h0 and per-step noise, story then image."""
    assert [d.shape for d in draws] == [(B_ST, 124), (B_ST, 365), (B_ST, 5, 100),
                                        (B_IM, 124), (B_IM, 365), (B_IM, 1, 100)]
    return tuple(tuple(torch.from_numpy(d.astype(np.float32)) for d in draws[i:i + 3])
                 for i in (0, 3))


PORT = {}  # (variant, which, dtype) -> (state, metrics, plain-kernel calls)


def port_step(variant, which, dtype="float32"):
    """The port's D or G step from the JAX state before, with JAX's noise,
    once a module; the kernels' plain versions counted."""
    key = (variant, which, dtype)
    if key not in PORT:
        state0, outs, (st, im) = variant_run(variant)
        tcfg = variant_configs(variant, COMPUTE_DTYPE=dtype)[1]
        state = copy.deepcopy(port_init(variant, dtype))
        load_jax_train_state(state, state0)
        draws = (jax_bf16_run()[which][2] if dtype == "bfloat16" else outs[which][2])
        calls = collections.Counter()

        def counted(kernel, fn):
            def call(*args):
                calls[kernel] += 1
                return fn(*args)
            return call

        d_step, g_step = make_train_steps(tcfg)
        with mock.patch.object(bn_cuda, "bn_stats_plain", counted("bn_stats",
                                                                   bn_cuda.bn_stats_plain)), \
                mock.patch.object(bn_cuda, "bn_grad_reduce_plain", counted(
                    "bn_grad_reduce", bn_cuda.bn_grad_reduce_plain)), \
                mock.patch.object(dynamic_filter, "dynamic_filter_conv1d_plain", counted(
                    "dfn_forward", dynamic_filter.dynamic_filter_conv1d_plain)):
            _, metrics = (d_step if which == "d" else g_step)(state, noise_of(draws), st, im,
                                                              4e-4)
        PORT[key] = state, metrics, calls
    return PORT[key]


@pytest.mark.parametrize("which", ["d", "g"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_step_matches_jax(variant, which):
    """Metrics (exactly the JAX step's tags), every BN running statistic and
    SN u of every net, and the stepped nets' gradients."""
    state0, outs, _ = variant_run(variant)
    jax_after, jax_metrics, _ = outs[which]
    state, metrics, _ = port_step(variant, which)
    tcfg = variant_configs(variant)[1]
    assert set(metrics) == set(jax_metrics)
    assert any(k.startswith("seg_D/") for k in metrics) == (which == "d" and tcfg.SEGMENT_LEARNING)
    for tag, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[tag]), float(value), **TOL, err_msg=tag)
    if tcfg.USE_SEQ_CONSISTENCY:  # the real terms, not the zero placeholder
        assert float(metrics["st_D/order" if which == "d" else "G/consistency"]) > 0
    assert set(state.nets()) == {"gen", "d_im", "d_st"} | ({"d_se"} if tcfg.SEGMENT_LEARNING
                                                          else set())
    seg = tcfg.SEGMENT_LEARNING
    after = jax_state_dicts(jax_after, use_segment=seg)
    grads = jax_state_dicts(jax_after, grads_of=state0, use_segment=seg)
    assert set(after) == set(state.nets())
    stepped = ("gen",) if which == "g" else tuple(KINDS)
    for name, net in state.nets().items():
        video = 0  # the VideoEncoder's statistics and u compared
        for key, buf in net.named_buffers():
            if key.endswith(("running_mean", "running_var", "weight_u")):
                close(buf, after[name][key], f"{variant} {which} step, {name}.{key}")
                video += "seq_consisten_model" in key
        assert (video > 0) == (name == "d_st" and tcfg.USE_SEQ_CONSISTENCY)
        if name not in stepped:
            assert all(p.grad is None for p in net.parameters()), f"{which} step changed {name}"
            continue
        ref = {key: np.asarray(grads[name][key]) for key, _ in net.named_parameters()}
        floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in ref.values())
        rtol = GRAD_RTOL_SEQ_G if (variant, which) == ("seq", "g") else GRAD_RTOL
        for key, p in net.named_parameters():
            err = np.linalg.norm(p.grad.numpy() - ref[key])
            assert err <= rtol * max(np.linalg.norm(ref[key]), floor), (
                f"{variant} {which} step, d {name}.{key}: error {err:.3e}, |ref| "
                f"{np.linalg.norm(ref[key]):.3e}")


def test_seq_g_gradients_hold_against_float64():
    """The ground for GRAD_RTOL_SEQ_G: from the same state and noise, the
    seq-consistency G step of the port in float64 (its plain kernels take any
    dtype; the float32 guard of train-mode BN is lifted for this run) against
    the port's float32 generator gradients and the JAX package's. Relative
    L2 per tensor, tensors whose gradient is 0 in exact arithmetic aside."""
    state0, outs, (st, im) = variant_run("seq")
    tcfg = variant_configs("seq")[1]
    state = copy.deepcopy(port_init("seq"))
    load_jax_train_state(state, state0)
    for net in state.nets().values():
        net.to(torch.float64)
    noise = tuple(tuple(t.double() for t in pair) for pair in noise_of(outs["g"][2]))
    cast = lambda batch, device: {k: torch.as_tensor(v).double()  # noqa: E731
                                  for k, v in batch.items() if isinstance(v, np.ndarray)}
    with mock.patch.object(steps_module, "batch_to_device", cast), \
            mock.patch.object(blocks, "batch_norm_train", batchnorm._BatchNormTrain.apply):
        make_train_steps(tcfg)[1](state, noise, st, im, 4e-4)
    exact = {k: p.grad.numpy() for k, p in state.gen.named_parameters()}
    ours = {k: p.grad.double().numpy()
            for k, p in port_step("seq", "g")[0].gen.named_parameters()}
    ref = jax_state_dicts(outs["g"][0], grads_of=state0)["gen"]
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in exact.values())
    worst = {"port": 0.0, "jax": 0.0}
    for key, g in exact.items():
        if np.linalg.norm(g) >= floor:
            worst["port"] = max(worst["port"], _rel(ours[key], g))
            worst["jax"] = max(worst["jax"], _rel(ref[key].numpy(), g))
    print(f"seq G gradients against float64, largest relative L2: port float32 "
          f"{worst['port']:.3e}, JAX float32 {worst['jax']:.3e}")
    assert worst["port"] <= GRAD_RTOL_SEQ_G_FLOAT64, worst
    assert worst["jax"] <= GRAD_RTOL_SEQ_G, worst


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_chip_smoke_launch_counts_match_a_variant_step(variant):
    """The per-step kernel launches chip_smoke.py derives from the code for
    each variant equal the plain-version calls of its CPU D and G steps."""
    calls = port_step(variant, "d")[2] + port_step(variant, "g")[2]
    expected = chip_smoke.per_step_launches(port_init(variant),
                                            variant_configs(variant)[1].USE_INFONCE)
    assert dict(calls) == {k: v for k, v in expected.items() if k != "dfn_backward"}


# The JAX package's two BN arms at bfloat16 for the seq-consistency D step,
# in relative L2 over each D's gradients: BN_BACKEND "pallas" (the port's
# arithmetic) against "xla" (which the bfloat16 configs run), measured with
# jax_bf16_run("pallas") against jax_bf16_run() at these widths and batches
# (the G step's generator: 0.436). The bound is twice that, as the cascade's
# bf16 steps are held in tests/test_torch_train_step.py. One bf16 step is compared: a JAX bf16 step costs ~20 s to
# trace here.
JAX_BF16_ARMS_SEQ = {"d_im": 0.075, "d_st": 0.269, "d_se": 0.069}
BF16_METRIC_TOL = dict(rtol=1e-2, atol=1e-3)
BF16_RUN = {}


def jax_bf16_run(arm="xla"):
    """The JAX seq-consistency D step at COMPUTE_DTYPE bfloat16 from the
    float32 variant's state and batches, with BN_BACKEND `arm`."""
    if arm not in BF16_RUN:
        state0, _, (st, im) = variant_run("seq")
        jcfg = variant_configs("seq", COMPUTE_DTYPE="bfloat16")[0].with_updates(BN_BACKEND=arm)
        BF16_RUN[arm] = _jax_steps(jcfg, state0, st, im, which=("d",))
    return BF16_RUN[arm]


def _distance(grads, ref):
    keys = list(grads)
    num = sum(float(np.sum((np.asarray(grads[k], np.float64) - np.asarray(ref[k])) ** 2))
              for k in keys)
    return np.sqrt(num / sum(float(np.sum(np.asarray(ref[k], np.float64) ** 2)) for k in keys))


def test_seq_step_at_bf16_holds_against_jax():
    """The seq-consistency D step at COMPUTE_DTYPE bfloat16 (the
    VideoEncoder's 3-D convs at bf16, its BNs reading bf16 maps, its
    parameters stepped): metrics within 1e-2 of the JAX package's bf16 step;
    each D's gradients within twice the JAX package's bf16-to-float32
    distance of the port's float32 ones, and within twice its two BN arms'
    spread of its bf16 ones; parameters, gradients, moments and BN
    statistics float32 and finite."""
    which = "d"
    state0, outs, _ = variant_run("seq")
    jax_bf16_after, jax_metrics, _ = jax_bf16_run()[which]
    state, metrics, _ = port_step("seq", which, "bfloat16")
    ours_f32 = port_step("seq", which)[0]
    assert set(metrics) == set(jax_metrics)
    for tag, value in jax_metrics.items():
        tol = dict(rtol=0, atol=0.1) if tag.startswith("Accuracy/") else BF16_METRIC_TOL
        np.testing.assert_allclose(float(metrics[tag]), float(value), **tol, err_msg=tag)
    jax_f32 = jax_state_dicts(outs[which][0], grads_of=state0)
    jax_bf16 = jax_state_dicts(jax_bf16_after, grads_of=state0)
    for name, arms in JAX_BF16_ARMS_SEQ.items():
        ours = {k: p.grad.numpy() for k, p in getattr(state, name).named_parameters()}
        f32 = {k: p.grad.numpy() for k, p in getattr(ours_f32, name).named_parameters()}
        own = _distance(ours, f32)
        jax_own = _distance({k: jax_bf16[name][k].numpy() for k in ours},
                            {k: jax_f32[name][k].numpy() for k in ours})
        direct = _distance(ours, {k: jax_bf16[name][k].numpy() for k in ours})
        print(f"{which} step, {name}: bf16 vs float32 gradients: port {own:.3f}, JAX "
              f"{jax_own:.3f}; port vs JAX bf16 {direct:.3f}, JAX's arms {arms:.3f}")
        assert own <= 2 * jax_own, (name, own, jax_own)
        assert direct <= 2 * arms, (name, direct, arms)
    for name, net in state.nets().items():
        tensors = [*net.parameters(), *(p.grad for p in net.parameters() if p.grad is not None),
                   *(v for s in state.opts[name].state.values() for v in s.values()
                     if v.dim() > 0),
                   *(b for k, b in net.named_buffers() if k.endswith(("running_mean",
                                                                      "running_var")))]
        assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in tensors), name


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """The logger writes metrics.jsonl only (importing tensorboardX takes seconds)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboardX", None)
        yield


def variant_file(tmp_path, variant, name):
    """final.yml with the variant's keys flipped, at the CLI tests' tiny
    widths, ST_BATCH 2 / IM_BATCH 4, a snapshot every epoch, as a YAML file."""
    from test_torch_cli import TINY
    cfg = config_from_file("final.yml").with_updates(**VARIANTS[variant])
    cfg = cfg.with_updates(CONFIG_NAME=name, GAN=TINY, TRAIN=dataclasses.replace(
        cfg.TRAIN, IM_BATCH_SIZE=4, ST_BATCH_SIZE=2, MAX_EPOCH=2, SNAPSHOT_INTERVAL=1))
    path = tmp_path / f"{name}.yml"
    path.write_text(yaml.safe_dump(dataclasses.asdict(cfg)))
    return str(path)


def cli(workdir, name, *argv):
    here = os.getcwd()
    os.chdir(workdir)
    try:
        return (main_pororo.main(list(argv) + ["--synthetic", "2", "--device", "cpu"]),
                os.path.join(workdir, "output", "torch", name))
    finally:
        os.chdir(here)


def test_trainer_shuffles_as_the_jax_trainer(tmp_path):
    """Each step's `shuffled` and `order_labels` are the JAX package's
    `create_random_shuffle` of the step's stories drawn from
    `np.random.default_rng([seed, epoch])`, reseeded every epoch
    (`cpcsv_tpu/train/trainer.py:218-227`), bit for bit, over 2 epochs of 2
    steps; epoch 1 starting from a resume draws the same."""
    from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders
    from cpcsv_tpu_torch.train import trainer as trainer_module

    cfg = config_from_file(variant_file(tmp_path, "seq", "tiny_seq"))
    seen = []

    def fake_steps(cfg):
        def d_step(state, rng, st_batch, im_batch, lr):
            seen.append({k: st_batch[k].numpy().copy()
                         for k in ("images", "shuffled", "order_labels")})
            return state, {"st_D/loss": torch.zeros(())}

        return d_step, lambda state, rng, st_batch, im_batch, lr: (state, {})

    def run(max_epoch, continue_ckpt=None):
        with mock.patch.object(trainer_module, "make_train_steps", fake_steps):
            trainer = trainer_module.GANTrainer(
                cfg.with_updates(TRAIN=dataclasses.replace(cfg.TRAIN, MAX_EPOCH=max_epoch)),
                str(tmp_path / "run"), seed=3, continue_ckpt=continue_ckpt, device="cpu")
            trainer.train(*synthetic_loaders(trainer.cfg, 4, seed=0)[:2])

    run(2)
    straight = seen[:]
    assert len(straight) == 4
    for epoch in (0, 1):
        rng = np.random.default_rng([3, epoch])
        for batch in straight[2 * epoch:2 * epoch + 2]:
            shuffled, labels = jax_create_random_shuffle(batch["images"], rng=rng)
            np.testing.assert_array_equal(batch["shuffled"], shuffled)
            np.testing.assert_array_equal(batch["order_labels"], labels)
    seen.clear()
    run(2, continue_ckpt=1)  # epoch 1 again, from the checkpoint of epoch 1
    assert len(seen) == 2
    for a, b in zip(seen, straight[2:]):
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_seq_consistency_cli_resumes_bitwise(tmp_path, capsys):
    """final.yml + USE_SEQ_CONSISTENCY through the CLI: two epochs straight
    equal one epoch and an auto-resumed second, every tensor of the state
    (the VideoEncoder's parameters, BN statistics, SN u and v, Adam moments
    inside d_st) and every logged metric, so the resumed epoch shuffled as
    the straight one did; st_D/order and G/consistency carry real terms."""
    from test_torch_cli import metric_records, tensors
    cfg = variant_file(tmp_path, "seq", "tiny_seq")
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
    straight, straight_dir = cli(tmp_path / "a", "tiny_seq", "--cfg", cfg)
    cli(tmp_path / "b", "tiny_seq", "--cfg", cfg, "--max_epoch", "1")
    resumed, resumed_dir = cli(tmp_path / "b", "tiny_seq", "--cfg", cfg, "--max_epoch", "2",
                               "--continue_ckpt", "auto")
    assert "Auto-resume from epoch 1" in capsys.readouterr().out
    a, b = tensors(straight), tensors(resumed)
    assert set(a) == set(b) and any("seq_consisten_model" in k and ".adam." not in k for k in a)
    assert any(k.startswith("d_st.adam.") for k in a)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    strip = lambda records: [(r["tag"], r["step"], r["value"]) for r in records  # noqa: E731
                             if not r["tag"].startswith("perf/")]
    records = strip(metric_records(straight_dir))
    assert strip(metric_records(resumed_dir)) == records
    for tag in ("st_D/order", "G/consistency"):
        values = [v for t, _, v in records if t == tag]
        assert values and all(np.isfinite(values)) and all(v > 0 for v in values), tag
    # the JAX trainer's tags for final.yml (seg D included), no cascade terms
    assert {t for t, _, _ in records} == (set(chip_smoke.CASCADE_TAGS)
                                          - set(chip_smoke.CASCADE_G_TAGS)
                                          - {"perf/frames_per_sec", "perf/epoch_seconds"})


def test_no_segment_cli_run_is_served(tmp_path):
    """final.yml + SEGMENT_LEARNING: false through the CLI for one epoch: no
    seg D anywhere (no netD_se file, three nets and Adams in the full state,
    no seg_D/* tag), a resume restores it, and `Infer` serves its snapshot:
    frames finite in [-1, 1], no mask."""
    from test_torch_cli import metric_records
    cfg_path = variant_file(tmp_path, "noseg", "tiny_noseg")
    state, run_dir = cli(tmp_path, "tiny_noseg", "--cfg", cfg_path, "--max_epoch", "1")
    assert state.d_se is None and set(state.opts) == {"gen", "d_im", "d_st"}
    model = os.path.join(run_dir, "Model")
    assert sorted(os.listdir(model)) == [
        "last_epoch.txt", "netD_im_epoch_last.pth", "netD_st_epoch_last.pth",
        "netG_epoch_0.pth", "netG_epoch_1.pth", "train_state_last.pth"]
    tags = {r["tag"] for r in metric_records(run_dir)}
    assert not any(t.startswith("seg_D/") for t in tags) and "Accuracy/se_G" in tags
    assert not os.path.exists(os.path.join(run_dir, "log", "segment_00000.png"))
    cfg = config_from_file(cfg_path)
    restored = CheckpointManager(model).restore(create_train_state(cfg, seed=1, device="cpu"))
    for name, net in state.nets().items():
        for key, value in net.state_dict().items():
            assert torch.equal(value, restored.nets()[name].state_dict()[key]), (name, key)
    infer = Infer(cfg, device="cpu", output_dir=run_dir, load_ckpt=1)
    video, mask = infer.sample_videos_np(next(story_batches(SyntheticStoryDataset(3), 3)),
                                         seg=True)
    assert video.shape == (3, 5, 64, 64, 3) and mask is None
    assert np.isfinite(video).all() and np.abs(video).max() <= 1
    # a seg-learning config refuses the seg-less state
    with pytest.raises(ValueError, match="SEGMENT_LEARNING"):
        CheckpointManager(model).restore(create_train_state(
            cfg.with_updates(SEGMENT_LEARNING=True), seed=1, device="cpu"))
