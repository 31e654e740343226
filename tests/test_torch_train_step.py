"""The port's alternating D step and G step against the JAX package's, for
`final.yml` (v1) and `cascade.yml`, and the cascade's seg autoencoder.

The port's initial state (tiny widths, the config otherwise) is carried into
a JAX `TrainState` by the JAX package's own converter (`utils/port_torch.py`)
and back into fresh port nets by `utils.weights.load_jax_train_state`; the
same numpy batches and the same noise (JAX's own draws, tapped while its step
runs) go through `cpcsv_tpu.train.steps.make_train_steps` and the port's.
Compared: every metric, every BN running statistic and SN u the step
mutated, and the gradients. JAX's gradients are recovered by replacing its
Adam with the identity transform, so that its update at lr = 1 is −g; the
port leaves its gradients in `.grad`.
"""

import collections
import copy
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

import cpcsv_tpu
from cpcsv_tpu.config import GanConfig as JaxGanConfig
from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.losses import gan_losses as jax_losses
from cpcsv_tpu.models import build_models as jax_build_models
from cpcsv_tpu.models import generator_from_config as jax_generator_from_config
from cpcsv_tpu.train import make_train_steps as jax_make_train_steps
from cpcsv_tpu.train.state import NetState as JaxNetState
from cpcsv_tpu.train.state import TrainState as JaxTrainState
from cpcsv_tpu.utils.benchutil import synthetic_batches as jax_synthetic_batches
from cpcsv_tpu.utils.port_torch import port_discriminator_state_dict, port_generator_state_dict
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import synthetic_batches
from cpcsv_tpu_torch.losses import gan_losses
from cpcsv_tpu_torch.ops import batchnorm, blocks, dynamic_filter
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.train.state import create_train_state, make_adam, weights_init
from cpcsv_tpu_torch.train import steps as steps_module
from cpcsv_tpu_torch.train.steps import make_train_steps
from cpcsv_tpu_torch.utils.weights import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_jax_train_state,
)
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

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
# The cascade G step chains more train-mode BNs (the re-encoder gates the
# image trunk, the autoencoder runs the seg trunk twice more). Against a
# float64 run of the port, JAX's float32 gradients differ by several times
# more than the port's float32 ones (largest at upsample4_seg's BN scale, 2
# channels at these widths, a sum that cancels), so the error is the
# reference's; `test_cascade_g_gradients_hold_against_float64` checks both.
# A wrong term moves a gradient by O(1).
GRAD_RTOL_CASCADE_G = 1e-1
# the port's float32 cascade G gradients against its float64 run
GRAD_RTOL_CASCADE_G_FLOAT64 = 2e-2


# the steps compared, by test id: (config, step)
STEPS = {"d": ("final.yml", "d"), "g": ("final.yml", "g"),
         "cascade-d": ("cascade.yml", "d"), "cascade-g": ("cascade.yml", "g")}


def configs(name="final.yml"):
    jcfg = jax_config_from_file(os.path.join(os.path.dirname(cpcsv_tpu.__file__), "configs",
                                             name))
    return (jcfg.with_updates(GAN=JaxGanConfig(**TINY)),
            config_from_file(name).with_updates(GAN=GanConfig(**TINY)))


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


def jax_state_from_port(state, tx):
    """The port's TrainState as the JAX package's, through its converter
    (numpy copies; optimizer states from `tx`)."""
    def net_state(variables):
        variables = jax.tree.map(np.array, variables)
        return JaxNetState(params=variables["params"], batch_stats=variables["batch_stats"],
                           spectral=variables.get("spectral", {}),
                           opt_state=tx.init(variables["params"]))

    sd = lambda net: net.state_dict()  # noqa: E731
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32),
        gen=net_state(port_generator_state_dict(sd(state.gen), cascade=state.gen.cascade)),
        **{name: net_state(port_discriminator_state_dict(sd(getattr(state, name)), kind))
           for name, kind in KINDS.items()})


@functools.lru_cache(maxsize=None)
def port_init(name):
    """The port's initial TrainState of a config (seed 0); callers step a
    deep copy."""
    return create_train_state(configs(name)[1], seed=0, device="cpu")


def _run(name):
    """JAX state before, after its D step and after its G step (both from the
    state before), with their metrics and noise, and the batches."""
    jcfg, tcfg = configs(name)
    models = jax_build_models(jcfg)
    state0 = jax_state_from_port(port_init(name), optax.identity())
    with mock.patch("cpcsv_tpu.train.steps.make_adam", lambda cfg=None: optax.identity()):
        d_step, g_step = jax_make_train_steps(jcfg, models, jit=False)
    st, im = synthetic_batches(tcfg, B_ST, B_IM, seed=4)
    out = {}
    # tracing a step allocates many short-lived objects, and the cyclic
    # garbage collector's passes over them are a sizeable share of its time
    gc.disable()
    try:
        with jax.default_matmul_precision("highest"):
            for which, step, key in (("d", d_step, 1), ("g", g_step, 2)):
                out[which] = tapped(step)(state0, jax.random.PRNGKey(key), st, im, 1.0)
    finally:
        gc.enable()
    to_np = lambda s: jax.tree.map(np.array, s)  # noqa: E731  writable host copies
    return to_np(state0), {k: to_np(v) for k, v in out.items()}, (st, im)


@pytest.fixture(scope="module")
def runs():
    """name -> `_run(name)`, each config's JAX steps traced once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run(name)
        return cache[name]

    return get


@pytest.fixture
def run(runs):
    return runs("final.yml")


# (config, "d" | "g") -> the calls port_step's step made to the kernels' plain
# versions, and port_step's result
PLAIN_CALLS, PORT_STEPS = {}, {}


def port_step(run, name, which):
    """The port's D or G step from the JAX state before, with JAX's noise:
    (state, metrics), taken once a module."""
    if (name, which) not in PORT_STEPS:
        PORT_STEPS[name, which] = _port_step(run, name, which)
    return PORT_STEPS[name, which]


def _port_step(run, name, which):
    state0, outs, (st, im) = run
    _, tcfg = configs(name)
    state = copy.deepcopy(port_init(name))
    load_jax_train_state(state, state0)
    draws = outs[which][2]
    # 6 draws: story then image, each CA eps, motion-GRU h0, per-step noise
    assert [d.shape for d in draws] == [(B_ST, 124), (B_ST, 365), (B_ST, 5, 100),
                                        (B_IM, 124), (B_IM, 365), (B_IM, 1, 100)]
    noise = tuple(tuple(torch.from_numpy(d) for d in draws[i:i + 3]) for i in (0, 3))
    d_step, g_step = make_train_steps(tcfg)
    calls = PLAIN_CALLS[name, which] = collections.Counter()

    def counted(kernel, fn):
        def call(*args):
            calls[kernel] += 1
            return fn(*args)
        return call

    with mock.patch.object(bn_cuda, "bn_stats_plain", counted("bn_stats", bn_cuda.bn_stats_plain)), \
            mock.patch.object(bn_cuda, "bn_grad_reduce_plain",
                              counted("bn_grad_reduce", bn_cuda.bn_grad_reduce_plain)), \
            mock.patch.object(dynamic_filter, "dynamic_filter_conv1d_plain", counted(
                "dfn_forward", dynamic_filter.dynamic_filter_conv1d_plain)):
        return (d_step if which == "d" else g_step)(state, noise, st, im, 4e-4)


def jax_state_dicts(state, grads_of=None, cascade=False):
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
                {"params": params, "batch_stats": net.batch_stats}, cascade=cascade)
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


@pytest.mark.parametrize("test_id", list(STEPS))
def test_step_metrics_state_and_gradients_match_jax(runs, test_id):
    name, which = STEPS[test_id]
    cascade = name == "cascade.yml"
    run = runs(name)
    state0, outs, _ = run
    jax_after, jax_metrics, _ = outs[which]
    state, metrics = port_step(run, name, which)
    assert set(metrics) == set(jax_metrics)
    cascade_tags = {"G/image_vae_loss", "G/video_vae_loss", "G/reconstruct_loss"}
    assert (cascade_tags <= set(metrics)) == (cascade and which == "g")
    for tag, value in jax_metrics.items():
        np.testing.assert_allclose(float(metrics[tag]), float(value), **TOL, err_msg=tag)

    after = jax_state_dicts(jax_after, cascade=cascade)
    grads = jax_state_dicts(jax_after, grads_of=state0, cascade=cascade)
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
        rtol = GRAD_RTOL_CASCADE_G if test_id == "cascade-g" else GRAD_RTOL
        for key, p in net.named_parameters():
            err = np.linalg.norm(p.grad.numpy() - ref[key])
            assert err <= rtol * max(np.linalg.norm(ref[key]), floor), (
                f"{which} step, d {name}.{key}: error {err:.3e}, |ref| "
                f"{np.linalg.norm(ref[key]):.3e}")
    assert state.step == (1 if which == "g" else 0)


def test_train_autoencoder_matches_jax():
    """The cascade's seg autoencoder in train mode: its output and the BN
    running statistics it updates (the re-encoder's and the seg trunk's)
    against JAX's `apply(method="train_autoencoder", mutable=["batch_stats"])`.
    Its gradients are held in the cascade G step above, where the
    reconstruction loss reaches them."""
    jcfg, tcfg = configs("cascade.yml")
    net = generator_from_config(tcfg).train()
    weights_init(net, torch.Generator().manual_seed(3))
    variables = jax.tree.map(np.array, port_generator_state_dict(net.state_dict(), cascade=True))
    before = generator_state_dict_from_jax(variables, cascade=True)
    masks = np.random.default_rng(8).uniform(-1, 1, (3, 64, 64, 1)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref, mut = jax.jit(lambda v, x: jax_generator_from_config(jcfg).apply(
            v, x, method="train_autoencoder", mutable=["batch_stats"]))(variables, masks)
    with torch.no_grad():
        out = net.train_autoencoder(torch.from_numpy(masks))
    assert out.shape == (3, 64, 64, 1)
    close(out, ref, "train_autoencoder output")
    after = generator_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.tree.map(np.array, mut["batch_stats"])},
        cascade=True)
    moved = set()
    for key, buf in net.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            close(buf, after[key], key)
            if not torch.equal(after[key], before[key]):
                moved.add(key.split(".")[0])
    # the re-encoder (presample, 4 down blocks) and the 4 up blocks of the seg trunk
    assert moved == {"presample", "downsample1_seg", "downsample2_seg", "downsample3_seg",
                     "downsample4_seg", "upsample1_seg", "upsample2_seg", "upsample3_seg",
                     "upsample4_seg"}


def test_cascade_g_gradients_hold_against_float64(runs):
    """The ground for GRAD_RTOL_CASCADE_G: from the same state and noise, the
    cascade G step of the port in float64 (its plain kernels take any
    dtype; the float32 guard of train-mode BN is lifted for this run) against
    the port's float32 gradients and the JAX package's. Relative L2 per
    tensor, tensors whose gradient is 0 in exact arithmetic aside."""
    name = "cascade.yml"
    run = runs(name)
    state0, outs, (st, im) = run
    jax_after, _, draws = outs["g"]
    _, tcfg = configs(name)

    def port_grads(dtype):  # the cascade G step of port_step, in `dtype`
        state = copy.deepcopy(port_init(name))
        load_jax_train_state(state, state0)
        for net in state.nets().values():
            net.to(dtype)
        noise = tuple(tuple(torch.from_numpy(d).to(dtype) for d in draws[i:i + 3])
                      for i in (0, 3))
        cast = lambda batch, device: {k: torch.as_tensor(v).to(dtype)  # noqa: E731
                                      for k, v in batch.items() if isinstance(v, np.ndarray)}
        with mock.patch.object(steps_module, "batch_to_device", cast), \
                mock.patch.object(blocks, "batch_norm_train", batchnorm._BatchNormTrain.apply):
            make_train_steps(tcfg)[1](state, noise, st, im, 4e-4)
        return {k: p.grad.double().numpy() for k, p in state.gen.named_parameters()}

    exact = port_grads(torch.float64)
    ours = {k: p.grad.double().numpy()
            for k, p in port_step(run, name, "g")[0].gen.named_parameters()}
    ref = jax_state_dicts(jax_after, grads_of=state0, cascade=True)["gen"]
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in exact.values())
    worst = {"port": 0.0, "jax": 0.0}
    for key, g in exact.items():
        norm = np.linalg.norm(g)
        if norm < floor:
            continue
        worst["port"] = max(worst["port"], np.linalg.norm(ours[key] - g) / norm)
        worst["jax"] = max(worst["jax"], np.linalg.norm(ref[key].numpy() - g) / norm)
    print(f"cascade G gradients against float64, largest relative L2: port float32 "
          f"{worst['port']:.3e}, JAX float32 {worst['jax']:.3e}")
    assert worst["port"] <= GRAD_RTOL_CASCADE_G_FLOAT64, worst
    assert worst["jax"] <= GRAD_RTOL_CASCADE_G, worst


# At COMPUTE_DTYPE bfloat16 a cascade step's gradients lie far from its
# float32 ones (relative L2 over a net's parameters: 1.2 for the generator,
# 0.09-0.62 for the discriminators), in the JAX package and in the port
# alike: JAX draws the CA eps in the CA codes' dtype, and the tiny random nets
# amplify rounding. The JAX package's two BN arms at bfloat16 (BN_BACKEND
# "xla", which the bfloat16 configs run, and "pallas", whose arithmetic the
# port follows) lie JAX_BF16_ARMS apart (measured with jax_bf16_step(runs,
# which, "pallas") against "xla"). So a net's bfloat16 gradients are held, in
# relative L2 over all its parameters:
#   * against the port's own float32 step, within twice the JAX package's
#     bfloat16-to-float32 distance;
#   * against the JAX package's bfloat16 step, within twice JAX_BF16_ARMS.
# The metrics are float32 losses of bfloat16 logits, features and frames:
# within 1e-2 relative of the JAX package's (its arms differ by up to 1.5e-3
# in the G step's), accuracies within 0.1 (a label or two of a few dozen
# flipping at p = 0.5).
JAX_BF16_ARMS = {"gen": 0.400, "d_im": 0.101, "d_st": 0.100, "d_se": 0.051}
BF16_METRIC_TOL = dict(rtol=1e-2, atol=1e-3)
BF16_STEPS = {}  # (step, BN arm) -> the JAX bfloat16 cascade step's (state, metrics, draws)


def jax_bf16_step(runs, which, arm="xla"):
    """The JAX cascade D or G step at COMPUTE_DTYPE bfloat16 from the state
    and batches of `runs("cascade.yml")`, with BN_BACKEND `arm`."""
    if (which, arm) not in BF16_STEPS:
        state0, _, (st, im) = runs("cascade.yml")
        jcfg = configs("cascade.yml")[0].with_updates(COMPUTE_DTYPE="bfloat16", BN_BACKEND=arm)
        with mock.patch("cpcsv_tpu.train.steps.make_adam", lambda cfg=None: optax.identity()):
            step = jax_make_train_steps(jcfg, jax_build_models(jcfg), jit=False)[which == "g"]
        gc.disable()
        try:
            out = tapped(step)(state0, jax.random.PRNGKey(1 if which == "d" else 2), st, im, 1.0)
        finally:
            gc.enable()
        BF16_STEPS[which, arm] = jax.tree.map(np.array, out)
    return BF16_STEPS[which, arm]


@pytest.mark.parametrize("which", ["d", "g"])
def test_cascade_step_at_bf16_holds_against_jax(runs, which):
    """procedural.yml's compute (cascade.yml's model at COMPUTE_DTYPE
    bfloat16) for one D or G step from the same state, batches and noise as
    the JAX package's: the metrics, each stepped net's gradients (see the
    bounds above), and every parameter, gradient, Adam moment and BN running
    statistic float32 and finite after it."""
    state0, outs, (st, im) = runs("cascade.yml")
    jax_f32 = jax_state_dicts(outs[which][0], grads_of=state0, cascade=True)
    jax_bf16, jax_metrics, draws = jax_bf16_step(runs, which)
    jax_bf16 = jax_state_dicts(jax_bf16, grads_of=state0, cascade=True)
    ours_f32 = port_step(runs("cascade.yml"), "cascade.yml", which)[0]

    _, tcfg = configs("procedural.yml")
    assert tcfg.COMPUTE_DTYPE == "bfloat16" and tcfg.CASCADE_MODEL
    state = create_train_state(tcfg, seed=0, device="cpu")
    load_jax_train_state(state, state0)
    noise = tuple(tuple(torch.from_numpy(d.astype(np.float32)) for d in draws[i:i + 3])
                  for i in (0, 3))
    d_step, g_step = make_train_steps(tcfg)
    _, metrics = (d_step if which == "d" else g_step)(state, noise, st, im, 4e-4)

    assert set(metrics) == set(jax_metrics)
    print({tag: f"{float(metrics[tag]):.5f} / {float(v):.5f}" for tag, v in jax_metrics.items()})
    for tag, value in jax_metrics.items():
        tol = dict(rtol=0, atol=0.1) if tag.startswith("Accuracy/") else BF16_METRIC_TOL
        np.testing.assert_allclose(float(metrics[tag]), float(value), **tol, err_msg=tag)

    def distance(grads, ref):
        keys = list(grads)
        num = sum(float(np.sum((np.asarray(grads[k], np.float64) - ref[k].numpy()) ** 2))
                  for k in keys)
        return np.sqrt(num / sum(float(np.sum(ref[k].numpy().astype(np.float64) ** 2))
                                 for k in keys))

    stepped = ("gen",) if which == "g" else tuple(KINDS)
    for name in stepped:
        ours = {k: p.grad.numpy() for k, p in getattr(state, name).named_parameters()}
        f32 = {k: p.grad for k, p in getattr(ours_f32, name).named_parameters()}
        to_port = lambda sd: {k: sd[name][k] for k in ours}  # noqa: E731
        own = distance(ours, f32)
        jax_own = distance({k: v.numpy() for k, v in to_port(jax_bf16).items()}, to_port(jax_f32))
        direct = distance(ours, to_port(jax_bf16))
        print(f"{which} step, {name}: bfloat16 gradients vs float32: port {own:.3f}, JAX "
              f"{jax_own:.3f}; port vs JAX {direct:.3f}, JAX's arms {JAX_BF16_ARMS[name]:.3f}")
        assert own <= 2 * jax_own, (name, own, jax_own)
        assert direct <= 2 * JAX_BF16_ARMS[name], (name, direct)
    for name, net in state.nets().items():
        tensors = [*net.parameters(), *(p.grad for p in net.parameters() if p.grad is not None),
                   *(v for s in state.opts[name].state.values() for v in s.values()
                     if v.dim() > 0),
                   *(b for k, b in net.named_buffers() if k.endswith(("running_mean",
                                                                      "running_var")))]
        assert all(t.dtype == torch.float32 and torch.isfinite(t).all() for t in tensors), name


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


def test_create_train_state_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(configs()[1], seed=0)


@pytest.mark.parametrize("name", ["final.yml", "cascade.yml"])
def test_chip_smoke_launch_counts_match_a_step(runs, name):
    """The per-step kernel launches that chip_smoke.py derives from the code
    equal the calls a D step and a G step of the parity tests above made to
    the kernels' plain versions on the CPU."""
    import chip_smoke

    calls = collections.Counter()
    for which in ("d", "g"):
        if (name, which) not in PLAIN_CALLS:  # this test alone: take the steps now
            port_step(runs(name), name, which)
        calls += PLAIN_CALLS[name, which]
    expected = chip_smoke.per_step_launches(port_init(name))
    assert dict(calls) == {k: v for k, v in expected.items() if k != "dfn_backward"}
