"""I3D (Inflated Inception-V1, Kinetics-400), the FVD embedder (counterpart
of `cpcsv_tpu/evaluation/i3d.py`; reference `fvd/frechet_video_distance.py:
36-136`, which runs the TF-Hub `i3d-kinetics-400` module). The embedding is
the 400-d logits, the module's "default" signature.

  * Unit3D = conv3d (no bias but in the logits) + BN (eps 1e-3) + ReLU, with
    TF "SAME" padding: asymmetric when its total is odd (pad // 2 before, the
    rest after), so it is applied with `F.pad` (zeros before a conv, -inf
    before a max pool) and the conv and pool run unpadded;
  * the logits head: a spatial mean, the mean of adjacent time steps when
    there are at least two (the Kinetics head's (2, 7, 7) VALID average pool
    at a 224 input), a 1 x 1 x 1 conv with bias, then the temporal mean;
  * input (N, 3, T, H, W) in [0, 1], resized spatially to 224 x 224
    (bilinear, align_corners=False, as `jax.image.resize` when upsampling;
    T is kept) and scaled to [-1, 1] (`preprocess`).

The parameter names and NCTHW kernels are piergiaj/pytorch-i3d's
(`Mixed_3b.b1b.conv3d.weight`, `...bn.running_mean`, `logits.conv3d.bias`),
so its state_dict loads as it is and the JAX package's
`load_torch_i3d_state_dict` converts this module's. `load_i3d_weights` also
reads the TF-Hub module's variable map exported to .npz.
`make_i3d_embedder` returns the metric's callable.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.evaluation.weights import Extractor, load_state_dict

INPUT_SIZE = 224


def same_pads(shape, kernel, stride) -> tuple[int, ...]:
    """`F.pad`'s amounts (last dim first) for TF SAME padding of the trailing
    len(kernel) dims of `shape`: pad // 2 before and the rest after."""
    pads = []
    for dim, k, s in zip(shape[-len(kernel):], kernel, stride):
        pad = max(0, (-(-dim // s) - 1) * s + k - dim)
        pads.append((pad // 2, pad - pad // 2))
    return tuple(p for before_after in reversed(pads) for p in before_after)


def max_pool_same(x: torch.Tensor, kernel, stride) -> torch.Tensor:
    return F.max_pool3d(F.pad(x, same_pads(x.shape, kernel, stride), value=-float("inf")),
                        kernel, stride)


class Unit3D(nn.Module):
    def __init__(self, inp: int, out: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 use_bn: bool = True, activation: bool = True, use_bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.activation = kernel, stride, activation
        self.conv3d = nn.Conv3d(inp, out, kernel, stride, bias=use_bias)
        self.bn = nn.BatchNorm3d(out, eps=1e-3) if use_bn else None

    def forward(self, x):
        x = self.conv3d(F.pad(x, same_pads(x.shape, self.kernel, self.stride)))
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionBlock(nn.Module):
    def __init__(self, inp: int, b0: int, b1: tuple, b2: tuple, b3: int):
        super().__init__()
        self.b0 = Unit3D(inp, b0)
        self.b1a = Unit3D(inp, b1[0])
        self.b1b = Unit3D(b1[0], b1[1], (3, 3, 3))
        self.b2a = Unit3D(inp, b2[0])
        self.b2b = Unit3D(b2[0], b2[1], (3, 3, 3))
        self.b3b = Unit3D(inp, b3)

    def forward(self, x):
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.b3b(max_pool_same(x, (3, 3, 3), (1, 1, 1)))], 1)


#: name: (input channels, b0, (b1 reduce, b1 out), (b2 reduce, b2 out), b3)
BLOCKS = {
    "Mixed_3b": (192, 64, (96, 128), (16, 32), 32),
    "Mixed_3c": (256, 128, (128, 192), (32, 96), 64),
    "Mixed_4b": (480, 192, (96, 208), (16, 48), 64),
    "Mixed_4c": (512, 160, (112, 224), (24, 64), 64),
    "Mixed_4d": (512, 128, (128, 256), (24, 64), 64),
    "Mixed_4e": (512, 112, (144, 288), (32, 64), 64),
    "Mixed_4f": (528, 256, (160, 320), (32, 128), 128),
    "Mixed_5b": (832, 256, (160, 320), (32, 128), 128),
    "Mixed_5c": (832, 384, (192, 384), (48, 128), 128),
}


def preprocess(x: torch.Tensor, resize: bool = True, normalize: bool = True) -> torch.Tensor:
    """(N, 3, T, H, W) in [0, 1] -> each frame resized to 224 x 224 (unless
    already so), then scaled to [-1, 1]."""
    if resize and x.shape[-2:] != (INPUT_SIZE, INPUT_SIZE):
        N, C, T, H, W = x.shape
        frames = x.transpose(1, 2).reshape(N * T, C, H, W)
        frames = F.interpolate(frames, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                               align_corners=False)
        x = frames.reshape(N, T, C, INPUT_SIZE, INPUT_SIZE).transpose(1, 2)
    return 2.0 * x - 1.0 if normalize else x


class I3D(nn.Module):
    """(N, 3, T, H, W) in [0, 1] -> (N, num_classes) logits."""

    def __init__(self, num_classes: int = 400, resize_input: bool = True,
                 normalize_input: bool = True):
        super().__init__()
        self.resize_input, self.normalize_input = resize_input, normalize_input
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2))
        self.Conv3d_2b_1x1 = Unit3D(64, 64)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3))
        for name, (inp, *branches) in BLOCKS.items():
            setattr(self, name, InceptionBlock(inp, *branches))
        self.logits = Unit3D(1024, num_classes, use_bn=False, activation=False, use_bias=True)

    def forward(self, x):
        x = preprocess(x, self.resize_input, self.normalize_input)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # the logits head; at a 224 input the spatial extent here is 7, so the
        # spatial mean is the Kinetics head's 7 x 7 window; its temporal window
        # of 2 averages adjacent pairs (an extent of 1 skips it)
        x = x.mean(dim=(3, 4), keepdim=True)
        if x.shape[2] >= 2:
            x = 0.5 * (x[:, :, 1:] + x[:, :, :-1])
        return self.logits(x).mean(dim=2).flatten(1)


# ------------------------------------------------------------------ weights
#: TF-Hub branch directory -> this module's unit, for its 1x1 and 3x3 convs.
#: Units are told apart by their kernel suffix, not the 0a/0b ordinal:
#: Mixed_5b names its Branch_2 3x3 conv `Conv3d_0a_3x3` (a checkpoint quirk).
_TF_BRANCH_UNITS = {
    "Branch_0": {"1x1": "b0"},
    "Branch_1": {"1x1": "b1a", "3x3": "b1b"},
    "Branch_2": {"1x1": "b2a", "3x3": "b2b"},
    "Branch_3": {"1x1": "b3b"},
}


def load_tf_i3d_variables(arrays) -> dict[str, np.ndarray]:
    """This module's state dict from the TF-Hub `i3d-kinetics-400` variable
    map (reference fvd/frechet_video_distance.py:55-70) exported to .npz, names
    like `RGB/inception_i3d/Mixed_3b/Branch_0/Conv3d_0a_1x1/conv_3d/w`, with
    or without a leading `module/` and a trailing `:0`. A TF kernel is
    (t, h, w, in, out), here (out, in, t, h, w); BN statistics are
    (1, 1, 1, 1, C); the module's BN has a shift and no scale, so the scale
    is ones; the logits unit `Logits/Conv3d_0c_1x1` has a bias and no BN."""
    state: dict[str, np.ndarray] = {}
    for raw_name, value in arrays.items():
        name = raw_name.split(":")[0]
        if "inception_i3d/" in name:
            name = name.split("inception_i3d/", 1)[1]
        parts = name.split("/")
        v = np.asarray(value)
        if parts[0].startswith("Conv3d_"):
            unit = parts[0]
        elif parts[0] == "Logits":
            unit = "logits"
        elif parts[0].startswith("Mixed_"):
            units = _TF_BRANCH_UNITS.get(parts[1])
            if units is None:
                raise ValueError(f"unrecognized I3D branch in {raw_name!r}")
            unit = f"{parts[0]}.{units['3x3' if parts[2].endswith('3x3') else '1x1']}"
        else:
            continue  # a Flow/ tower or an optimizer slot
        sub, leaf = parts[-2], parts[-1]
        if sub == "conv_3d" and leaf in ("w", "b"):
            state[f"{unit}.conv3d.{'weight' if leaf == 'w' else 'bias'}"] = (
                v.transpose(4, 3, 0, 1, 2) if leaf == "w" else v.reshape(-1))
        elif sub == "batch_norm":
            key = {"beta": "bias", "gamma": "weight", "moving_mean": "running_mean",
                   "moving_variance": "running_var"}.get(leaf)
            if key:
                state[f"{unit}.bn.{key}"] = v.reshape(-1)
    if not state:
        raise ValueError("no TF-Hub I3D variables recognized in the archive")
    for key in [k for k in state if k.endswith(".bn.bias")]:
        state.setdefault(key.removesuffix("bias") + "weight", np.ones_like(state[key]))
    return state


def load_i3d_weights(path: str) -> dict[str, np.ndarray]:
    """This module's state dict from either layout, told apart by its names:
    a TF-Hub variable map (`load_tf_i3d_variables`) or a pytorch-i3d state
    dict, .pth or .npz."""
    sd = load_state_dict(path)
    if any("conv_3d/" in k or "inception_i3d" in k for k in sd):
        return load_tf_i3d_variables(sd)
    return sd


class ClipEmbedder(Extractor):
    """The I3D Extractor, its backbone tagged "i3d" as the JAX package's. It
    takes the folder datasets' [-1, 1] clips and shifts them to the [0, 1]
    the network takes, as the JAX package's embedder does."""

    def __init__(self, weights_path: str | None, device: str | torch.device):
        super().__init__(I3D(), "i3d_kinetics400", weights_path, device, load_i3d_weights)
        self.backbone = "i3d"

    def __call__(self, x) -> np.ndarray:
        return super().__call__((np.asarray(x, np.float32) + 1.0) / 2.0)


def make_i3d_embedder(weights_path: str | None = None,
                      device: str | torch.device = "cuda") -> ClipEmbedder:
    """clips (N, T, H, W, 3) in [-1, 1] -> (N, 400) logits on `device`. The
    weights resolve through `evaluation.weights` (`i3d_kinetics400`); without
    a file the network runs from random init, warns, and is tagged
    `random_init=True`."""
    return ClipEmbedder(weights_path, device)
