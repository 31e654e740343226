"""Train-mode BatchNorm with the port's reduction kernels.

Counterpart of `cpcsv_tpu/ops/batchnorm.py` (`bn_train_core`, `_bn_fwd`,
`_bn_bwd`), which has flax BatchNorm's semantics:

  * forward: (s, q) = bn_stats(x); mean = s/M, var = max(0, q/M − mean²)
    (flax's fast variance); y = (x − mean)·(rsqrt(var + eps)·scale) + bias,
    in float32;
  * backward: (sdy, sdyx) = bn_grad_reduce(x, dy, mean, invstd);
    dx = scale·invstd·(dy − sdy/M − xhat·sdyx/M), dscale = sdyx, dbias = sdy.
    No gradient flows through the returned mean and var: they only feed the
    running update, which nothing differentiates;
  * running update (`update_running_stats`): momentum 0.1 (flax 0.9), with
    torch's unbiased variance, var·M/(M−1).

M = N·H·W. A CUDA tensor goes to the kernels (`ops/cuda/bn.py`), a CPU
tensor to their plain versions; the normalize and dx passes are plain
PyTorch on both, as the JAX package computes them outside Pallas too.
"""

from __future__ import annotations

import torch

from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

MOMENTUM = 0.1


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or the CPU, got {x.device}")
    return True


def bn_stats(x3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(x3, "bn_stats"):
        return bn_cuda.bn_stats_plain(x3)
    return bn_cuda.bn_stats(x3)


def bn_grad_reduce(x3, dy3, mean, invstd) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(x3, "bn_grad_reduce"):
        return bn_cuda.bn_grad_reduce_plain(x3, dy3, mean, invstd)
    return bn_cuda.bn_grad_reduce(x3, dy3, mean, invstd)


class _BatchNormTrain(torch.autograd.Function):
    """(x (N, C, ...), scale [C], bias [C]) -> (y, mean, var), float32."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x3 = x.reshape(x.shape[0], x.shape[1], -1).contiguous()
        M = x3.shape[0] * x3.shape[2]
        s, q = bn_stats(x3)
        mean = s / M
        var = torch.clamp(q / M - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (x3 - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]
        ctx.save_for_backward(x3, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y.view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x3, scale, mean, inv = ctx.saved_tensors
        dy3 = dy.reshape(x3.shape).contiguous()
        M = x3.shape[0] * x3.shape[2]
        sdy, sdyx = bn_grad_reduce(x3, dy3, mean, inv)
        xhat = (x3 - mean[:, None]) * inv[:, None]
        dx = (scale * inv)[:, None] * (dy3 - (sdy / M)[:, None] - xhat * (sdyx / M)[:, None])
        return dx.view(dy.shape), sdyx, sdy, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BN of float32 x (N, C) or (N, C, H, W) with batch statistics:
    (y, batch mean, biased batch var)."""
    if x.dtype != torch.float32:
        raise TypeError(f"train-mode BatchNorm runs in float32, got {x.dtype}")
    return _BatchNormTrain.apply(x, scale, bias, eps)


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, M: int) -> None:
    """In place: ra = 0.9·ra + 0.1·batch, the variance Bessel-corrected."""
    bessel = M / max(M - 1, 1)
    running_mean.mul_(1.0 - MOMENTUM).add_(mean, alpha=MOMENTUM)
    running_var.mul_(1.0 - MOMENTUM).add_(var * bessel, alpha=MOMENTUM)
