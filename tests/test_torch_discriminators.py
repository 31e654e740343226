"""The port's discriminators and spectral norm against the JAX package's.

JAX variables (tiny width DF_DIM=16, the real condition width 489; a port
discriminator's init through the JAX package's converter, BN moved) are
converted with `cpcsv_tpu_torch.utils.weights.discriminator_state_dict_from_jax`
and loaded strictly; the same numpy inputs go through `d_phase` / `g_phase`
on both sides in train mode. Compared: every logit, the character logits,
and the BN running statistics and SN u that the calls mutated
(JAX `mutable=["batch_stats", "spectral"]`), including the batch-1 guard
that skips the wrong-pair head call.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpcsv_tpu.models.discriminators import (
    ImageDiscriminator as JaxImageD,
    SegDiscriminator as JaxSegD,
    StoryDiscriminator as JaxStoryD,
)
from cpcsv_tpu.ops.spectral_norm import SNConv
from cpcsv_tpu.utils.export_torch import export_discriminator_variables
from cpcsv_tpu.utils.port_torch import port_discriminator_state_dict
from cpcsv_tpu_torch.models import discriminators
from cpcsv_tpu_torch.ops.spectral_norm import SNConv2d
from cpcsv_tpu_torch.utils.weights import discriminator_state_dict_from_jax
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)

NDF, COND, TEXT, LABELS, T = 16, 124, 356, 9, 5
NEF = COND + TEXT + LABELS
KW = dict(ndf=NDF, nef=COND, text_dim=TEXT, label_num=LABELS)
# float32 on both sides; the convolutions and the BN reductions sum in other
# orders, and train-mode BN over a few rows divides by batch deviations
TOL = dict(rtol=1e-4, atol=1e-4)


def models(kind):
    if kind == "story":
        return JaxStoryD(**KW), discriminators.StoryDiscriminator(**KW)
    if kind == "seg":
        return JaxSegD(**KW, in_channels=1), discriminators.SegDiscriminator(**KW)
    return JaxImageD(**KW), discriminators.ImageDiscriminator(**KW)


def inputs(kind, B, seed):
    rng = np.random.default_rng(seed)
    shape = (B, T, 64, 64, 3) if kind == "story" else (B, 64, 64, 1 if kind == "seg" else 3)
    real = rng.standard_normal(shape).astype(np.float32)
    fake = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    return real, fake, rng.standard_normal((B, NEF)).astype(np.float32)


def port_variables(port_d, kind):
    """The port discriminator's weights as JAX variables (numpy copies),
    through the JAX package's own converter: its tree is flax's, and building
    it costs no trace of flax's init."""
    return jax.tree.map(np.array, port_discriminator_state_dict(port_d.state_dict(), kind))


@pytest.fixture(scope="module", params=["image", "seg", "story"])
def setup(request):
    """(kind, JAX module, its variables as numpy, port module loaded with them)."""
    kind = request.param
    jax_d, port_d = models(kind)
    torch.manual_seed(3)
    variables = port_variables(port_d, kind)
    # BN scale and bias away from 1 and 0, so their use is seen
    rng = np.random.default_rng(1)

    def move(tree):
        for key, sub in tree.items():
            if key == "scale":
                tree[key] = rng.uniform(0.5, 1.5, sub.shape).astype(np.float32)
            elif key == "bias" and sub.ndim == 1 and sub.shape[0] > 1:
                tree[key] = (0.3 * rng.standard_normal(sub.shape)).astype(np.float32)
            elif isinstance(sub, dict):
                move(sub)

    move(variables["params"])
    port_d.load_state_dict(discriminator_state_dict_from_jax(variables, kind), strict=True)
    return kind, jax_d, variables, port_d.train()


def _run_both(setup, phase, B):
    kind, jax_d, variables, port_d = setup
    real, fake, cond = inputs(kind, B, seed=10 + B)
    port_d.load_state_dict(discriminator_state_dict_from_jax(variables, kind), strict=True)
    args = (real, fake, cond) if phase == "d_phase" else (fake, cond)
    with jax.default_matmul_precision("highest"):
        ref, mut = jax.jit(functools.partial(jax_d.apply, method=phase,
                                             mutable=["batch_stats", "spectral"]))(
            variables, *map(jnp.asarray, args))
    with torch.no_grad():
        ours = getattr(port_d, phase)(*map(torch.from_numpy, args))
    return kind, variables, port_d, ours, ref, mut


@pytest.mark.parametrize("phase,B", [("d_phase", 3), ("g_phase", 3), ("d_phase", 1)])
def test_phase_matches_jax(setup, phase, B):
    kind, variables, port_d, ours, ref, mut = _run_both(setup, phase, B)
    ref = [r for r in ref if r is not None]  # JAX's story heads also return None slots
    ours = [o for o in ours if o is not None]
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)
    if phase == "d_phase" and B == 1:
        assert ours[1].shape == (0,)  # no wrong pair, no head call
    after = discriminator_state_dict_from_jax(
        {"params": variables["params"], **jax.tree.map(np.asarray, dict(mut))}, kind)
    before = discriminator_state_dict_from_jax(variables, kind)
    moved = 0
    for key, buf in port_d.named_buffers():
        if key.endswith(("running_mean", "running_var", "weight_u")):
            np.testing.assert_allclose(buf.numpy(), after[key].numpy(), err_msg=key, **TOL)
            moved += not np.array_equal(after[key].numpy(), before[key].numpy())
    assert moved > 0


@pytest.mark.parametrize("kind", ["image", "seg", "story"])
def test_state_dict_matches_export(kind):
    _, port_d = models(kind)
    torch.manual_seed(4)
    variables = port_variables(port_d, kind)
    ours = discriminator_state_dict_from_jax(variables, kind)
    ref = export_discriminator_variables(variables, kind)
    assert set(ours) == set(ref) == set(port_d.state_dict())
    for key, value in ref.items():
        # weight_v: both normalise W_matᵀu computed in float64
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(value), rtol=1e-6, atol=1e-7,
                                   err_msg=key)


def test_seg_discriminator_refuses_rgb():
    _, port_d = models("seg")
    with pytest.raises(ValueError, match="1-channel"):
        port_d(torch.zeros(2, 64, 64, 3))


def test_spectral_norm_matches_jax_snconv():
    """Two train-mode calls: output, the u after each, and the gradient of
    the weight through σ computed from the live W."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, 8, 5)).astype(np.float32)
    w_out = rng.standard_normal((2, 4, 4, 7)).astype(np.float32)
    mod = SNConv(7, (4, 4), 2, ((1, 1), (1, 1)))
    variables = jax.tree.map(np.array, mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    conv = SNConv2d(5, 7, 4, 2, 1)
    with torch.no_grad():
        conv.weight_orig.copy_(torch.from_numpy(variables["params"]["kernel"].transpose(3, 2, 0, 1)))
        conv.weight_u.copy_(torch.from_numpy(variables["spectral"]["u"]))
    spectral = variables["spectral"]

    def loss(kernel, spectral):
        y, mut = mod.apply({"params": {"kernel": kernel}, "spectral": spectral},
                           jnp.asarray(x), sn_update=True, mutable=["spectral"])
        return jnp.sum(y * w_out), (y, mut["spectral"])

    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    for _ in range(2):
        (_, (y_ref, spectral)), g_ref = value_and_grad(
            jnp.asarray(variables["params"]["kernel"]), spectral)
        conv.weight_orig.grad = None
        y = conv(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        (y * torch.from_numpy(w_out.transpose(0, 3, 1, 2))).sum().backward()
        np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y_ref),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(conv.weight_u.numpy(), np.asarray(spectral["u"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(conv.weight_orig.grad.numpy(),
                                   np.asarray(g_ref).transpose(3, 2, 0, 1), rtol=1e-4, atol=1e-5)
