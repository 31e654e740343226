"""JAX variables -> the port's `state_dict`s.

Counterpart of `cpcsv_tpu/utils/export_torch.py` (`export_generator_variables`,
`export_discriminator_variables`). The port's module names are the reference
torch layout's, so the result, like a reference `netG_epoch_E.pth` or
`netD_*.pth`, loads with ``load_state_dict(strict=True)``:

  * dense kernels (I, O) -> Linear weight (O, I)
  * conv kernels (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw), and
    (kt, kh, kw, I, O) -> Conv3d weight (O, I, kt, kh, kw)
  * GRU stacks keep the [r|z|n] gate order, transposed
  * BN scale / bias / mean / var -> weight / bias / running_mean /
    running_var, plus num_batches_tracked = 0 (inert at momentum 0.1)
  * a spectral-normed conv's or dense layer's kernel -> weight_orig, its
    u -> weight_u, and weight_v = normalize(W_matᵀ u), the v of torch's
    next power iteration
  * the story D's order-consistency VideoEncoder, where the JAX variables
    hold one, under `seq_consisten_model.` (`models/video_encoder.py`)
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(leaf) -> torch.Tensor:
    return torch.from_numpy(np.array(leaf, copy=True))


def _unconv(kernel) -> torch.Tensor:
    """(k..., I, O) -> (O, I, k...), 2-D or 3-D."""
    kernel = np.asarray(kernel)
    nd = kernel.ndim - 2
    return _tensor(kernel.transpose(nd + 1, nd, *range(nd)))


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


def _sn_layer(out, params, spectral, prefix, dense=False):
    w = _tensor(np.asarray(params["kernel"]).T) if dense else _unconv(params["kernel"])
    u = _tensor(spectral["u"])
    w_mat = w.reshape(w.shape[0], -1).double()
    v = w_mat.t() @ u.double()
    out[f"{prefix}.weight_orig"] = w
    out[f"{prefix}.weight_u"] = u
    out[f"{prefix}.weight_v"] = (v / max(float(v.norm()), 1e-12)).float()
    if "bias" in params:
        out[f"{prefix}.bias"] = _tensor(params["bias"])


def video_encoder_state_dict_from_jax(variables: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """VideoEncoder {'params', 'batch_stats', 'spectral'} (numpy leaves) ->
    state_dict of `models/video_encoder.VideoEncoder`, its keys under `prefix`."""
    params, stats, spectral = variables["params"], variables["batch_stats"], variables["spectral"]
    out: dict[str, torch.Tensor] = {}
    p = prefix
    convs = [("stem0", "story_encoder.0.0", "story_encoder.0.1"),
             ("stem1", "story_encoder.0.3", "story_encoder.0.4")]
    convs += [(f"body{i}", f"story_encoder.{1 + 3 * i}", f"story_encoder.{2 + 3 * i}")
              for i in range(8)]
    for name, conv, bn in convs:
        _sn_layer(out, params[name], spectral[name], p + conv)
        _bn(out, params[f"{name}_bn"], stats[f"{name}_bn"], p + bn)
    _sn_layer(out, params["det0"], spectral["det0"], f"{p}detector.0", dense=True)
    _bn(out, params["det_bn"], stats["det_bn"], f"{p}detector.1")
    _sn_layer(out, params["det1"], spectral["det1"], f"{p}detector.3", dense=True)
    return out


def discriminator_state_dict_from_jax(variables: dict, kind: str) -> dict[str, torch.Tensor]:
    """{Image,Seg,Story}Discriminator {'params', 'batch_stats', 'spectral'}
    (numpy leaves) -> state_dict of the port's discriminator of `kind`
    ("image" | "seg" | "story"), the story D's VideoEncoder included when
    the variables hold one."""
    if kind not in ("image", "seg", "story"):
        raise ValueError(f"kind must be image|seg|story, got {kind!r}")
    params, stats, spectral = variables["params"], variables["batch_stats"], variables["spectral"]
    out: dict[str, torch.Tensor] = {}
    enc, enc_st, enc_sn = params["encode_img"], stats["encode_img"], spectral["encode_img"]
    if kind == "story":
        _sn_layer(out, enc["c0"], enc_sn["c0"], "encode_img.0")
    else:
        out["encode_img.0.weight"] = _unconv(enc["c0"]["conv"]["kernel"])
    for i, idx in enumerate((2, 5, 8)):
        _sn_layer(out, enc[f"c{i + 1}"], enc_sn[f"c{i + 1}"], f"encode_img.{idx}")
        _bn(out, enc[f"bn{i + 1}"], enc_st[f"bn{i + 1}"], f"encode_img.{idx + 1}")
    head, head_sn = params["get_cond_logits"], spectral["get_cond_logits"]
    _sn_layer(out, head["conv"], head_sn["conv"], "get_cond_logits.outlogits.0")
    _bn(out, head["bn"], stats["get_cond_logits"]["bn"], "get_cond_logits.outlogits.1")
    _sn_layer(out, head["out"], head_sn["out"], "get_cond_logits.outlogits.3")
    if kind != "story":
        out["cate_classify.weight"] = _unconv(params["cate_classify"]["conv"]["kernel"])
    elif "seq_consisten_model" in params:
        out.update(video_encoder_state_dict_from_jax(
            {coll: variables[coll]["seq_consisten_model"]
             for coll in ("params", "batch_stats", "spectral")}, "seq_consisten_model."))
    return out


def load_jax_train_state(state, jax_state) -> None:
    """Loads a JAX `TrainState` (its NetStates' params, batch_stats and
    spectral, numpy leaves) into the port's `train.state.TrainState`, strictly.
    The generator's variant (segment learning, cascade) is the port
    generator's own, as its config built it; without segment learning
    neither state has a seg D. The Adam moments are not carried over: the
    optimizers keep theirs."""
    state.gen.load_state_dict(generator_state_dict_from_jax(
        {"params": jax_state.gen.params, "batch_stats": jax_state.gen.batch_stats},
        use_segment=state.gen.use_segment, cascade=state.gen.cascade), strict=True)
    for name, kind in (("d_im", "image"), ("d_st", "story"), ("d_se", "seg")):
        net = getattr(jax_state, name)
        if net is None and getattr(state, name) is None:
            continue
        variables = {"params": net.params, "batch_stats": net.batch_stats,
                     "spectral": net.spectral}
        getattr(state, name).load_state_dict(
            discriminator_state_dict_from_jax(variables, kind), strict=True)
