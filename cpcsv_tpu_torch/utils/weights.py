"""JAX generator variables -> the port's `state_dict`.

Counterpart of the generator part of `cpcsv_tpu/utils/export_torch.py`
(`export_generator_variables`). The port's module names are the reference
torch layout's, so the result, like a reference `netG_epoch_E.pth`, loads
with ``load_state_dict(strict=True)``:

  * dense kernels (I, O) -> Linear weight (O, I)
  * conv kernels (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
  * GRU stacks keep the [r|z|n] gate order, transposed
  * BN scale / bias / mean / var -> weight / bias / running_mean /
    running_var, plus num_batches_tracked = 0 (inert at momentum 0.1)
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True))


def _unconv(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def _bn(out, params, stats, prefix):
    out[f"{prefix}.weight"] = _tensor(params["scale"])
    out[f"{prefix}.bias"] = _tensor(params["bias"])
    out[f"{prefix}.running_mean"] = _tensor(stats["mean"])
    out[f"{prefix}.running_var"] = _tensor(stats["var"])
    out[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _dense(out, params, stats, name):
    dense = params[name]["dense"]
    out[f"{name}.0.weight"] = _tensor(np.asarray(dense["kernel"]).T)
    if "bias" in dense:
        out[f"{name}.0.bias"] = _tensor(dense["bias"])
    _bn(out, params[name]["bn"], stats[name]["bn"], f"{name}.1")


def _gru(out, params, name):
    node = params[name]
    out[f"{name}.weight_ih"] = _tensor(np.asarray(node["w_ih"]).T)
    out[f"{name}.weight_hh"] = _tensor(np.asarray(node["w_hh"]).T)
    out[f"{name}.bias_ih"] = _tensor(node["b_ih"])
    out[f"{name}.bias_hh"] = _tensor(node["b_hh"])


def _up(out, params, stats, name):
    out[f"{name}.1.weight"] = _unconv(params[name]["conv"]["kernel"])
    _bn(out, params[name]["bn"], stats[name]["bn"], f"{name}.2")


def generator_state_dict_from_jax(
    variables: dict, use_segment: bool = True, cascade: bool = False
) -> dict[str, torch.Tensor]:
    """StoryGenerator {'params', 'batch_stats'} (numpy leaves) -> state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    out: dict[str, torch.Tensor] = {}
    ca = params["ca_net"]["fc"]
    out["ca_net.fc.weight"] = _tensor(np.asarray(ca["kernel"]).T)
    out["ca_net.fc.bias"] = _tensor(ca["bias"])
    for name in ("filter_net", "image_net", "fc", "m_net", "c_net"):
        _dense(out, params, stats, name)
    _gru(out, params, "recurrent")
    _gru(out, params, "mocornn")
    for i in (1, 2, 3, 4):
        _up(out, params, stats, f"upsample{i}")
    out["img.0.weight"] = _unconv(params["img"]["kernel"])

    if use_segment:
        _dense(out, params, stats, "fc_seg")
        for i in (1, 2, 3, 4):
            _up(out, params, stats, f"upsample{i}_seg")
        out["img_seg.0.weight"] = _unconv(params["img_seg"]["kernel"])
        out["seg_c.weight"] = _unconv(params["seg_c"]["kernel"])
        out["seg_c1.weight"] = _unconv(params["seg_c1"]["kernel"])
        if cascade:
            out["presample.0.weight"] = _unconv(params["presample_conv"]["kernel"])
            _bn(out, params["presample_bn"], stats["presample_bn"], "presample.1")
            for i in (1, 2, 3, 4):
                name = f"downsample{i}_seg"
                out[f"{name}.0.weight"] = _unconv(params[name]["conv"]["kernel"])
                out[f"{name}.0.bias"] = _tensor(params[name]["conv"]["bias"])
                _bn(out, params[name]["bn"], stats[name]["bn"], f"{name}.1")
    return out
