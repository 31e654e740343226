"""WGAN-GP gradient penalty (counterpart of
`cpcsv_tpu/losses/gradient_penalty.py`; reference `fid/helper.py:159-178`,
an unused utility there):

    gp = mean_i (‖∇_x̂ D(x̂)_i‖₂ − 1)²,  x̂ = α·real + (1 − α)·fake,  α ~ U(0, 1) a sample

No training step of either package calls it. The penalty's gradient is a
double backward through the critic, so the critic must be twice
differentiable: the port's train-mode BatchNorm (`ops/batchnorm.py`) has a
hand-written backward that is not, so hold a critic with BN in eval mode or
use one without BN.
"""

from __future__ import annotations

from typing import Callable

import torch


def gradient_penalty(critic: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, generator: torch.Generator | None = None,
                     alpha: torch.Tensor | None = None) -> torch.Tensor:
    """critic: samples (N, ...) -> scores (N,). α is drawn from `generator`
    unless given, shape (N, 1, ...). Returns the scalar penalty, differentiable
    in the critic's parameters and in real and fake (create_graph=True)."""
    if alpha is None:
        alpha = torch.rand((real.shape[0],) + (1,) * (real.dim() - 1), generator=generator,
                           dtype=real.dtype, device=real.device)
    interp = alpha * real + (1.0 - alpha) * fake
    if not interp.requires_grad:  # a leaf then: the inputs take no gradient
        interp.requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(interp).sum(), interp, create_graph=True)
    norms = torch.sqrt(grads.reshape(real.shape[0], -1).square().sum(dim=1) + 1e-12)
    return torch.mean(torch.square(norms - 1.0))
