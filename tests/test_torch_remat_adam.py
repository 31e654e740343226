"""REMAT and ADAM_MU_DTYPE in the port, on the CPU at tiny widths.

REMAT (`models/generator.py`, `torch.utils.checkpoint` on every UpBlock and
DownBlock) against the JAX package's `nn.remat`: the same weights and noise
through a train-mode generator with a loss on its frames, as
`tests/test_remat.py` runs it; and against the port without REMAT, a whole
D+G step, with the BN state bit for bit. ADAM_MU_DTYPE (`train/state.py`'s
Adam) against optax's `scale_by_adam(mu_dtype=...)`, the checkpoint's dtype
flip both ways, and the float32 path against `torch.optim.Adam`, bit for bit.
"""

import copy
import dataclasses
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from cpcsv_tpu.config import GanConfig as JaxGanConfig
from cpcsv_tpu.config import config_from_file as jax_config_from_file
from cpcsv_tpu.models import generator_from_config as jax_generator_from_config
from cpcsv_tpu.utils.port_torch import port_generator_state_dict
from cpcsv_tpu_torch.config import GanConfig, config_from_file
from cpcsv_tpu_torch.data.synthetic import synthetic_batches
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
from cpcsv_tpu_torch.train.state import create_train_state, make_adam, weights_init
from cpcsv_tpu_torch.train.steps import make_train_steps
from cpcsv_tpu_torch.utils.weights import generator_state_dict_from_jax
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

TINY = dict(CONDITION_DIM=124, Z_DIM=100, DF_DIM=8, GF_DIM=4, GF_SEG_DIM=16)
# the JAX comparison at tests/test_torch_train_step.py's widths and 4 stories:
# at 2 stories (6 rows) the 2-channel seg BNs' scale gradients, sums that
# cancel, lie up to 0.1 apart in float32 between the two packages
REMAT_DIMS, B, T = dict(TINY, DF_DIM=16, GF_DIM=8, GF_SEG_DIM=32), 4, 3
GRAD_RTOL = 1e-2  # tests/test_torch_train_step.py's


def test_remat_matches_jax_nn_remat():
    """cascade.yml's generator at 3 frames with REMAT, train mode: the loss
    sum(frames²), its gradient for every parameter and the BN running
    statistics after the call, against the JAX package's generator with
    REMAT (`nn.remat`) on the same weights and noise. float32 on both sides,
    summed in other orders, as `tests/test_torch_train_step.py` holds a step:
    the loss at 1e-5 relative, the statistics at 1e-3 relative + 1e-4 of
    their scale, each gradient within GRAD_RTOL = 1e-2 relative L2 of JAX's
    (of 1e-4 of the largest gradient's norm where JAX's is 0 in exact
    arithmetic); the largest error here is ~2.4e-4.
    The backward recomputed the blocks (bn_stats ran once more for each)."""
    jcfg = jax_config_from_file("cpcsv_tpu/configs/cascade.yml").with_updates(
        GAN=JaxGanConfig(**REMAT_DIMS), VIDEO_LEN=T, REMAT=True)
    cfg = config_from_file("cascade.yml").with_updates(GAN=GanConfig(**REMAT_DIMS), VIDEO_LEN=T,
                                                       REMAT=True)
    net = generator_from_config(cfg).train()
    weights_init(net, torch.Generator().manual_seed(2))
    variables = jax.tree.map(np.array, port_generator_state_dict(net.state_dict(), cascade=True))
    rng = np.random.default_rng(0)
    motion = rng.standard_normal((B, T, 365)).astype(np.float32)
    content = rng.standard_normal((B, T, 356)).astype(np.float32)
    gen, real = jax_generator_from_config(jcfg), jax.random.normal

    def loss(params):
        draws = []

        def tap(key, shape=(), dtype=jnp.float32):
            x = real(key, shape, dtype)
            if sys._getframe(1).f_code.co_filename.endswith("models/generator.py"):
                draws.append(x)
            return x

        jax.random.normal = tap
        try:
            out, mut = gen.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 motion, content, method="sample_videos",
                                 rngs={"noise": jax.random.PRNGKey(4)}, mutable=["batch_stats"])
        finally:
            jax.random.normal = real
        return jnp.sum(jnp.square(out.image)), (mut["batch_stats"], draws)

    with jax.default_matmul_precision("highest"):
        (ref_loss, (stats, draws)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    ref_grads = generator_state_dict_from_jax(
        {"params": jax.tree.map(np.array, grads), "batch_stats": variables["batch_stats"]},
        cascade=True)
    ref_stats = generator_state_dict_from_jax(
        {"params": variables["params"], "batch_stats": jax.tree.map(np.array, stats)},
        cascade=True)

    calls, real_stats = [], bn_cuda.bn_stats_plain
    with mock.patch.object(bn_cuda, "bn_stats_plain", lambda x: calls.append(1) or real_stats(x)):
        out = net.sample_videos(torch.from_numpy(motion), torch.from_numpy(content),
                                noise=tuple(torch.from_numpy(np.array(d)) for d in draws))
        forward_calls = len(calls)
        ours = out.image.square().sum()
        ours.backward()
    blocks = sum(len(chip_smoke.bn_modules(m)) for name, m in net.named_children()
                 if name.startswith(("upsample", "downsample")))
    assert len(calls) - forward_calls == blocks == 12  # 4 + 4 up blocks and 4 down blocks
    np.testing.assert_allclose(ours.item(), float(ref_loss), rtol=1e-5)
    largest = max(np.linalg.norm(g.numpy()) for g in ref_grads.values())
    for key, p in net.named_parameters():
        ref = ref_grads[key].numpy()
        err = np.linalg.norm(p.grad.numpy() - ref)
        assert err <= GRAD_RTOL * max(np.linalg.norm(ref), 1e-4 * largest), (key, err)
    for key, buf in net.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            ref = ref_stats[key].numpy()
            np.testing.assert_allclose(buf.numpy(), ref, rtol=1e-3,
                                       atol=1e-4 * (np.abs(ref).max() or 1.0), err_msg=key)
        elif key.endswith("num_batches_tracked"):
            assert int(buf) == 1, key  # one update a call, the recompute writes none


@pytest.mark.parametrize("name", ["final.yml", "cascade.yml", "clevr.yml"])
def test_remat_step_equals_no_remat(name):
    """A D+G step with REMAT against one without, from one state and noise:
    every parameter, Adam moment, BN running statistic and
    num_batches_tracked bit for bit (the recompute reruns the same plain
    sums on the same inputs and writes no BN state), the same metrics; the
    G step's extra bn_stats calls are the ones chip_smoke.py counts."""
    base = config_from_file(name).with_updates(GAN=GanConfig(**TINY))
    states, metrics, calls = {}, {}, {}
    for remat in (False, True):
        cfg = base.with_updates(REMAT=remat)
        state = create_train_state(cfg, seed=0, device="cpu")
        st, im = synthetic_batches(cfg, 2, 4, seed=1)
        d_step, g_step = make_train_steps(cfg)
        rng = torch.Generator().manual_seed(5)
        counted = []
        real = bn_cuda.bn_stats_plain
        with mock.patch.object(bn_cuda, "bn_stats_plain",
                               lambda x: counted.append(1) or real(x)):
            _, dm = d_step(state, rng, st, im, 4e-4)
            _, gm = g_step(state, rng, st, im, 1e-4)
        states[remat], metrics[remat], calls[remat] = state, {**dm, **gm}, len(counted)
        assert state.gen.remat == remat
    assert {k: float(v) for k, v in metrics[True].items()} == \
        {k: float(v) for k, v in metrics[False].items()}
    for net, ref in zip(states[True].nets().values(), states[False].nets().values()):
        for (key, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
            assert torch.equal(a, b), key
    for n, opt in states[True].opts.items():
        for a, b in zip(opt.state.values(), states[False].opts[n].state.values()):
            assert all(torch.equal(a[k], b[k]) for k in ("exp_avg", "exp_avg_sq")), n
    expected = chip_smoke.per_step_launches(states[True])["bn_stats"]
    assert calls[True] == expected == calls[False] + {"cascade.yml": 40}.get(name, 13)


def _three_updates(mu_dtype, torch_opt=None):
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((4, 6)).astype(np.float32)
    grads = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = (torch_opt or (lambda ps: make_adam(ps, mu_dtype)))([param])
    for g, lr in zip(grads, (4e-4, 1e-4, 2e-4)):
        param.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return p0, grads, param, opt


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_adam_mu_dtype_matches_optax(mu_dtype):
    """Three updates against optax's scale_by_adam(b1=0.5, b2=0.999, eps=1e-8,
    mu_dtype) followed by −lr·u: the parameters (float32 both sides, the
    same formula in another operation order: rtol 1e-6, atol 1e-7 as
    `test_adam_matches_optax`), the second moment (float32: 1e-6), and the
    first moment stored in `mu_dtype`, within one rounding of it of optax's
    (torch's lerp and optax's weighted sum may round the float32 moment a
    last bit apart, which can move its bfloat16 rounding by one step)."""
    p0, grads, param, opt = _three_updates(mu_dtype)
    tx = optax.scale_by_adam(b1=0.5, b2=0.999, eps=1e-8,
                             mu_dtype=jnp.bfloat16 if mu_dtype == "bfloat16" else None)
    ref = jnp.asarray(p0)
    opt_state = tx.init(ref)
    for g, lr in zip(grads, (4e-4, 1e-4, 2e-4)):
        update, opt_state = tx.update(jnp.asarray(g), opt_state, ref)
        ref = ref - lr * update
    state = opt.state[param]
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    mu, nu = opt_state.mu, opt_state.nu
    assert state["exp_avg"].dtype == getattr(torch, mu_dtype) and mu.dtype == jnp.dtype(mu_dtype)
    assert state["exp_avg_sq"].dtype == torch.float32
    np.testing.assert_allclose(state["exp_avg_sq"].numpy(), np.asarray(nu), rtol=1e-6)
    step = 2 ** -8 if mu_dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(state["exp_avg"].float().numpy(), np.asarray(mu, np.float32),
                               rtol=step, atol=0)


def torch_adam(params):
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


def test_float32_adam_is_torch_adam_bitwise():
    """At float32 the port's Adam gives torch.optim.Adam's bits, and reads a
    state_dict that torch.optim.Adam wrote: a resume from a checkpoint
    written before the port had its own Adam continues bit for bit. A copy
    keeps the first moment's dtype."""
    ours, ref = _three_updates("float32"), _three_updates("float32", torch_adam)
    assert torch.equal(ours[2], ref[2])
    assert torch.equal(ours[3].state[ours[2]]["exp_avg"], ref[3].state[ref[2]]["exp_avg"])
    params = [torch.nn.Parameter(ref[2].detach().clone()) for _ in range(2)]
    opts = make_adam(params[:1]), torch_adam(params[1:])
    for p, opt in zip(params, opts):
        opt.load_state_dict(copy.deepcopy(ref[3].state_dict()))
        p.grad = torch.ones(4, 6)
        opt.param_groups[0]["lr"] = 3e-4
        opt.step()
    assert torch.equal(params[0], params[1])
    assert torch.equal(opts[0].state[params[0]]["exp_avg"], opts[1].state[params[1]]["exp_avg"])
    assert copy.deepcopy(make_adam(params[:1], "bfloat16")).mu_dtype == torch.bfloat16


@pytest.mark.parametrize("saved,loaded", [("bfloat16", "float32"), ("float32", "bfloat16")])
def test_checkpoint_casts_the_first_moments(tmp_path, saved, loaded):
    """A full state saved at one ADAM_MU_DTYPE restores into optimizers of
    the other, its first moments cast to theirs (a bfloat16 moment comes
    back exactly; a float32 one rounds to nearest even), every other tensor
    as saved; the next step runs."""
    cfg = config_from_file("final.yml").with_updates(GAN=GanConfig(**TINY))
    state = create_train_state(cfg.with_updates(ADAM_MU_DTYPE=saved), seed=0, device="cpu")
    st, im = synthetic_batches(cfg, 2, 4, seed=1)
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator().manual_seed(5)
    d_step(state, rng, st, im, 4e-4)
    g_step(state, rng, st, im, 1e-4)
    ckpt = CheckpointManager(str(tmp_path / "Model"))
    ckpt.save(state, 0)
    other = create_train_state(cfg.with_updates(ADAM_MU_DTYPE=loaded), seed=1, device="cpu")
    ckpt.restore(other)
    want = getattr(torch, loaded)
    for n, opt in other.opts.items():
        for a, b in zip(opt.state.values(), state.opts[n].state.values()):
            assert a["exp_avg"].dtype == want and a["exp_avg_sq"].dtype == torch.float32
            assert torch.equal(a["exp_avg"], b["exp_avg"].to(want)), n
            assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"]) and a["step"] == b["step"]
    for net, ref in zip(other.nets().values(), state.nets().values()):
        assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                     ref.state_dict().values()))
    d_step(other, rng, st, im, 4e-4)
    assert all(s["exp_avg"].dtype == want for opt in other.opts.values()
               for s in opt.state.values())


def test_adam_mu_dtype_refuses_what_the_jax_config_refuses():
    cfg = config_from_file("final.yml").with_updates(GAN=GanConfig(**TINY),
                                                     ADAM_MU_DTYPE="float16")
    with pytest.raises(ValueError, match="ADAM_MU_DTYPE must be 'float32' or 'bfloat16'"):
        create_train_state(cfg, seed=0, device="cpu")
    assert dataclasses.asdict(config_from_file("final.yml"))["ADAM_MU_DTYPE"] == "float32"
