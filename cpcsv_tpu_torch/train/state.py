"""Train state: the generator and the three discriminators, each with its own
Adam optimizer (counterpart of `cpcsv_tpu/train/state.py`; reference
`trainer.py:212-220`).

Adam has β = (0.5, 0.999) and eps 1e-8. The learning rate is not part of the
state: the train steps set it on every call, as the JAX steps take `lr` as
an argument (`state.py:66-70`). `torch.optim.Adam` computes optax's
`scale_by_adam` followed by −lr·u. A net's BN running statistics and SN
vectors live in its buffers, as its `batch_stats` and `spectral`
collections do in JAX. Without SEGMENT_LEARNING there is no seg D: `d_se` is
None, and `nets()` and `opts` leave it out (three Adams, not four), as the
JAX state's `d_se` is None.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import resolve_device
from cpcsv_tpu_torch.models.factory import build_models

NETS = ("gen", "d_im", "d_st", "d_se")


@dataclasses.dataclass
class TrainState:
    gen: nn.Module
    d_im: nn.Module
    d_st: nn.Module
    d_se: Optional[nn.Module]
    opts: dict[str, torch.optim.Optimizer]  # keyed by the names of nets()
    step: int = 0

    def nets(self) -> dict[str, nn.Module]:
        """The nets the state has, by name, in NETS order."""
        return {name: getattr(self, name) for name in NETS if getattr(self, name) is not None}


def make_adam(params) -> torch.optim.Adam:
    """Adam(β = 0.5, 0.999, eps 1e-8); the steps set the learning rate."""
    return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)


@torch.no_grad()
def weights_init(net: nn.Module, generator: torch.Generator) -> None:
    """The reference init (`miscc/utils.py:191-201`, the JAX package's
    initializers): conv and linear weights N(0, 0.02), their biases 0, BN
    scale N(1, 0.02) and bias 0 with fresh running statistics; GRU cells
    keep torch's U(−1/√H, 1/√H). A spectral-normed conv's u is drawn anew
    and its v is the u's next power-iteration v. All draws from `generator`."""
    for mod in net.modules():
        if isinstance(mod, (nn.Conv2d, nn.Conv3d, nn.Linear)):
            weight = getattr(mod, "weight_orig", mod.weight)
            weight.normal_(0.0, 0.02, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
            if hasattr(mod, "weight_u"):
                u = torch.randn(mod.weight_u.shape, generator=generator, device=weight.device)
                mod.weight_u.copy_(F.normalize(u, dim=0, eps=1e-12))
                w_mat = weight.reshape(weight.shape[0], -1)
                mod.weight_v.copy_(F.normalize(w_mat.t() @ mod.weight_u, dim=0, eps=1e-12))
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.weight.normal_(1.0, 0.02, generator=generator)
            mod.bias.zero_()
            mod.reset_running_stats()
        elif isinstance(mod, nn.GRUCell):
            bound = mod.hidden_size ** -0.5
            for p in mod.parameters():
                p.uniform_(-bound, bound, generator=generator)


def create_train_state(cfg: Config, seed: int = 0, device: str | torch.device = "cuda") -> TrainState:
    """The nets of `cfg` (`models.factory.build_models`), in train mode,
    initialised from `seed` on `device`, with their optimizers. It runs on
    the card unless the caller passes device="cpu"."""
    dev = resolve_device(device)
    state = TrainState(*build_models(cfg), opts={})
    generator = torch.Generator(device=dev).manual_seed(seed)
    for name, net in state.nets().items():
        net.to(dev).train()
        weights_init(net, generator)
        state.opts[name] = make_adam(net.parameters())
    return state
