"""Weights of the metric backbones: where they are found, how they load, a
fingerprint of the file, and the warning when there are none (counterpart
of `cpcsv_tpu/evaluation/weights.py`); and `make_extractor`, which puts a
backbone on a device behind the numpy interface the metrics call.

The reference's metrics run pretrained backbones (fid/fid_score.py:48-56,
pt_inception-2015-12-05; fid/vfid_score.py:50-60, torchvision's Kinetics
r2plus1d_18). Weights are never downloaded here. A backbone without a
weights file runs from random initialisation, and that must never pass for
a real score:

  * weights resolve through `resolve_weights()`: an explicit path, then
    $CPCSV_METRIC_WEIGHTS_DIR, then ~/.cache/cpcsv_tpu/weights, the JAX
    package's search order and file names, so one directory serves both;
  * a random-init extractor warns with `RandomInitMetricWarning` and is
    tagged `random_init = True`, and every walk's row carries the tag;
  * `weights_fingerprint()` names the file an extractor loaded.

The files hold the torch layout (pytorch-fid / torchvision / pytorch-i3d
names, NCHW and NCTHW kernels), as .pth or as .npz of the same arrays; I3D
also reads the TF-Hub module's variable map (`i3d.load_i3d_weights`).
"""

from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

from cpcsv_tpu_torch.device import float32_math, resolve_device


class RandomInitMetricWarning(UserWarning):
    """A metric's feature extractor is running with RANDOM weights."""


#: the file names searched for each backbone, in order
REGISTRY: dict[str, tuple[str, ...]] = {
    "inception_fid": (
        "inception_fid.npz",
        "pt_inception-2015-12-05.npz",
        "pt_inception-2015-12-05-galloway_rc.pth",
        "pt_inception-2015-12-05.pth",
    ),
    "r2plus1d_18": (
        "r2plus1d_18.npz",
        "r2plus1d_18-91a641e6.npz",
        "r2plus1d_18-91a641e6.pth",
    ),
    "i3d_kinetics400": (
        "i3d_kinetics400.npz",
        "i3d_rgb_kinetics400.npz",
        "i3d_tfhub_kinetics400.npz",  # the TF-Hub module's variable map (`i3d.load_i3d_weights`)
        "i3d_kinetics400.pth",
    ),
}


def weights_search_dirs() -> list[str]:
    dirs = []
    env = os.environ.get("CPCSV_METRIC_WEIGHTS_DIR")
    if env:
        dirs.append(env)
    dirs.append(os.path.expanduser("~/.cache/cpcsv_tpu/weights"))
    return dirs


def resolve_weights(name: str, explicit: str | None = None) -> str | None:
    """The weights file of backbone `name` (a REGISTRY key): `explicit`,
    which must exist, else the first file of the search directories; None
    when there is none."""
    if explicit:
        if not os.path.exists(explicit):
            raise FileNotFoundError(f"{name}: weights file not found: {explicit}")
        return explicit
    for d in weights_search_dirs():
        for fname in REGISTRY.get(name, ()):
            p = os.path.join(d, fname)
            if os.path.exists(p):
                return p
    return None


def load_state_dict(path: str) -> dict[str, np.ndarray]:
    """A torch-layout state dict from .npz or .pth, as numpy arrays."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def weights_fingerprint(path: str | None) -> str:
    """A short stable id of a weights file; without one, 'random-init-torch':
    the port's random init is not the JAX package's 'random-init', and the
    real-side statistics cached under a fingerprint (`features.
    activation_statistics`) must never pass from one to the other."""
    if not path:
        return "random-init-torch"
    h = hashlib.sha256()
    h.update(os.path.basename(path).encode())
    h.update(str(os.path.getsize(path)).encode())
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
    return h.hexdigest()[:12]


def warn_random_init(name: str) -> None:
    warnings.warn(
        f"{name}: no pretrained weights found: the extractor runs RANDOM "
        f"initialization, so any FID/FSD/FVD/IS computed with it is NOT comparable to "
        f"published numbers. Provide weights through the factory's weights_path "
        f"argument, $CPCSV_METRIC_WEIGHTS_DIR, or ~/.cache/cpcsv_tpu/weights "
        f"(accepted file names: {', '.join(REGISTRY.get(name, ()))}).",
        RandomInitMetricWarning,
        stacklevel=3,
    )


def random_init_(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Convolution kernels LeCun-normal (std 1/sqrt(fan_in), as the JAX
    package's flax init) from a torch.Generator seeded `seed`; BN as
    constructed (scale 1, shift 0, mean 0, variance 1). The values differ
    from the JAX package's random init: neither is a real score."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=gen)
    return net


def load_into(net: torch.nn.Module, state: dict) -> None:
    """Every parameter and BN statistic of `net` from `state` (numpy or
    tensors); keys the backbone does not use (the classifier heads) are left
    out, and a missing BN batch count is allowed (the ported .npz files
    hold none)."""
    own = net.state_dict()
    missing = [k for k in own if k not in state and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"weights lack {len(missing)} of the backbone's tensors, e.g. {missing[:3]}")
    net.load_state_dict({k: torch.as_tensor(np.asarray(state[k])) for k in own if k in state},
                        strict=False)


class Extractor:
    """A backbone on a device behind the metrics' numpy interface: a batch
    (N, ..., 3) channel-last float in, (N, features) float32 out. The
    backbone runs in eval mode, without gradients, in float32 with TF32 off
    (`device.float32_math`). Its weights are the file of REGISTRY[`backbone`]
    that `resolve_weights` finds, read by `read` (a state dict in the net's
    names), else random init. `random_init`, `fingerprint` and `backbone`
    (its name) tag what it computes."""

    def __init__(self, net: torch.nn.Module, backbone: str, weights_path: str | None,
                 device: str | torch.device = "cuda", read=load_state_dict):
        self.device = resolve_device(device)
        path = resolve_weights(backbone, weights_path)
        if path:
            load_into(net, read(path))
        else:
            warn_random_init(backbone)
            random_init_(net)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.backbone = backbone
        self.random_init = path is None
        self.fingerprint = weights_fingerprint(path)

    @torch.no_grad()
    def __call__(self, x) -> np.ndarray:
        t = torch.as_tensor(np.asarray(x, np.float32)).to(self.device)
        t = t.movedim(-1, 1)  # channels first: NCHW, or NCTHW for videos
        with float32_math():
            return self.net(t).cpu().numpy()
