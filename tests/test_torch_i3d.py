"""The port's I3D, the FVD embedder (`cpcsv_tpu_torch/evaluation/i3d.py`),
against the JAX package's (`cpcsv_tpu/evaluation/i3d.py`) on the CPU.

One set of weights goes to both: the port's network, BN calibrated on one
train-mode pass (`torch_cpu.calibrated_backbone`; a random net's features
otherwise barely depend on the input), carried to JAX by its
`load_torch_i3d_state_dict`. Held at rtol 1e-2 / atol 1e-3 (the JAX
package's own I3D converter test, `tests/test_i3d_port.py`), on clips of 10
and 20 frames: after the stem, 10 frames leave 2 time steps, where the
logits head's pair average is a plain mean, and 20 leave 3, where it is not.
The TF-Hub variable map is read by both packages from one .npz; the input
preprocessing (resize to 224, rescale) is held without the network.

The `cuda`-marked test holds the network on the card against the CPU and
skips without a card; JAX is reached through a fixture, so it runs where
JAX is absent:

    python -m pytest --noconftest tests/test_torch_i3d.py -m cuda
"""

import importlib

import numpy as np
import pytest
import torch

from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.evaluation import i3d
from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning, random_init_
from torch_cpu import calibrated_backbone
from torch_cpu import one_torch_thread  # noqa: F401  (an autouse fixture)


@pytest.fixture(scope="module")
def jax_i3d():
    return importlib.import_module("cpcsv_tpu.evaluation.i3d")


def relative_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("frames", [10, 20])
def test_i3d_matches_jax_with_the_same_weights(jax_i3d, frames):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(frames)
    calib, x = (rng.uniform(-1, 1, (2, frames, 64, 64, 3)).astype(np.float32) for _ in "ab")
    net = calibrated_backbone(i3d.I3D(resize_input=False, normalize_input=False), calib, frames)
    with torch.no_grad():
        ours = net(torch.from_numpy(x).movedim(-1, 1)).numpy()
    variables = jax_i3d.load_torch_i3d_state_dict(net.state_dict())
    model = jax_i3d.I3D(resize_input=False, normalize_input=False)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x)))
    assert ours.shape == (2, 400) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=1e-2, atol=1e-3)
    # the part of the logits that depends on the input: the difference of the two clips
    assert relative_l2(ours[0] - ours[1], ref[0] - ref[1]) < 1e-3
    assert np.linalg.norm(ours[0] - ours[1]) > 0.05 * np.linalg.norm(ours)


def test_tf_hub_variable_map_loads_as_in_jax(jax_i3d, tmp_path):
    """One TF-Hub-layout .npz (`module/` prefix, `:0` suffix, (t, h, w, in,
    out) kernels, (1, 1, 1, 1, C) BN arrays, no BN scale, Mixed_5b's
    misnamed 3x3 conv), read by both packages: the same weights leaf for
    leaf, and the port's state equal to the network it was written from."""
    from test_i3d_port import _tf_varmap_from_torch

    net = random_init_(i3d.I3D(), 3)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.9, 1.1)
                m.bias.normal_(0, 0.05)  # the module's BN has a shift, and no scale
        net.logits.conv3d.bias.normal_(0, 0.05)
    path = tmp_path / "i3d_tfhub_kinetics400.npz"
    np.savez(path, **_tf_varmap_from_torch(net))
    assert any("Mixed_5b/Branch_2/Conv3d_0a_3x3" in k for k in np.load(path).files)

    ours = i3d.load_i3d_weights(str(path))
    expected = {k: v.numpy() for k, v in net.state_dict().items()
                if not k.endswith("num_batches_tracked")}
    assert set(ours) == set(expected)
    for key, value in expected.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    ref = jax_i3d.load_i3d_weights(str(path))
    carried = jax_i3d.load_torch_i3d_state_dict(ours)
    import jax

    leaves = dict(jax.tree_util.tree_leaves_with_path(carried))
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) == len(ref_leaves)
    for key, value in ref_leaves:
        np.testing.assert_array_equal(leaves[key], value, err_msg=str(key))
    # the embedder takes the file through the registry's loader
    embedder = i3d.make_i3d_embedder(str(path), "cpu")
    assert not embedder.random_init and embedder.backbone == "i3d"
    assert torch.equal(embedder.net.Mixed_5b.b2b.conv3d.weight,
                       net.Mixed_5b.b2b.conv3d.weight)


def test_preprocessing_matches_jax():
    """Frames resized to 224 x 224 (T kept) and scaled to [-1, 1], as the JAX
    I3D's first lines; a 224 input is only scaled."""
    import jax
    import jax.numpy as jnp

    x = np.random.default_rng(4).uniform(0, 1, (2, 3, 16, 20, 3)).astype(np.float32)
    ours = i3d.preprocess(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).numpy()
    ref = 2.0 * np.asarray(jax.image.resize(jnp.asarray(x), (2, 3, 224, 224, 3), "bilinear")) - 1
    assert ours.shape == (2, 3, 224, 224, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    full = torch.rand(1, 3, 2, 224, 224)
    assert torch.equal(i3d.preprocess(full), 2.0 * full - 1.0)
    assert torch.equal(i3d.preprocess(full, resize=False, normalize=False), full)


def test_same_padding_is_tf_same():
    """Odd totals put the extra zero after: the stem's 7-tap stride-2 conv on
    64 pads (2, 3), a 3-tap stride-1 pool (1, 1), a 2-tap stride-2 pool on an
    odd 5 (0, 1)."""
    assert i3d.same_pads((1, 3, 10, 64, 64), (7, 7, 7), (2, 2, 2)) == (2, 3, 2, 3, 2, 3)
    assert i3d.same_pads((1, 3, 5, 8, 8), (3, 3, 3), (1, 1, 1)) == (1, 1, 1, 1, 1, 1)
    assert i3d.same_pads((1, 3, 5, 4, 4), (2, 2, 2), (2, 2, 2)) == (0, 0, 0, 0, 0, 1)
    x = torch.full((1, 1, 1, 1, 2), -5.0)
    assert torch.equal(i3d.max_pool_same(x, (1, 1, 3), (1, 1, 1)), x)  # -inf padding


def test_embedder_tags_and_shifts_its_input(monkeypatch, tmp_path):
    """Without weights: a warning naming i3d_kinetics400, the tags; a call
    feeds the network [0, 1] clips, channels first."""
    monkeypatch.setenv("CPCSV_METRIC_WEIGHTS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(RandomInitMetricWarning, match="i3d_kinetics400"):
        embedder = i3d.make_i3d_embedder(None, "cpu")
    assert embedder.random_init and embedder.backbone == "i3d"
    assert embedder.fingerprint == "random-init-torch"
    seen = []
    embedder.net = lambda t: seen.append(t) or t.flatten(1)
    clips = np.random.default_rng(5).uniform(-1, 1, (2, 4, 6, 6, 3)).astype(np.float32)
    embedder(clips)
    torch.testing.assert_close(seen[0], torch.from_numpy((clips + 1) / 2).movedim(-1, 1))


@pytest.mark.cuda
def test_cuda_i3d_matches_cpu():
    """The embedder's network at 224 x 224 x 10, BN calibrated, on the card
    against the CPU, float32 with TF32 off: raw logits and the difference of
    two clips at 1e-3 relative L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    calib, x = (rng.uniform(0, 1, (2, 10, 64, 64, 3)).astype(np.float32) for _ in "ab")
    net = calibrated_backbone(i3d.I3D(), calib, 1)
    t = torch.from_numpy(x).movedim(-1, 1)
    with torch.no_grad(), float32_math():
        cpu = net(t).numpy()
        card = net.cuda()(t.cuda()).cpu().numpy()
    assert relative_l2(card, cpu) < 1e-3
    assert relative_l2(card[0] - card[1], cpu[0] - cpu[1]) < 1e-3
