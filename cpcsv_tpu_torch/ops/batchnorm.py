"""Train-mode BatchNorm with the port's reduction kernels.

Counterpart of `cpcsv_tpu/ops/batchnorm.py` (`bn_train_core`, `_bn_fwd`,
`_bn_bwd`), which has flax BatchNorm's semantics:

  * forward: (s, q) = bn_stats(x); mean = s/M, var = max(0, q/M − mean²)
    (flax's fast variance); y = (x − mean)·(rsqrt(var + eps)·scale) + bias,
    in float32, cast to x's dtype at the end;
  * backward: (sdy, sdyx) = bn_grad_reduce(x, dy, mean, invstd);
    dx = scale·invstd·(dy − sdy/M − xhat·sdyx/M), dscale = sdyx, dbias = sdy,
    in float32, dx cast to x's dtype. No gradient flows through the returned
    mean and var: they only feed the running update, which nothing
    differentiates;
  * running update (`update_running_stats`): momentum 0.1 (flax 0.9), with
    torch's unbiased variance, var·M/(M−1).

M = N·H·W (N·T·H·W for a 5-D map, N for a dense one). x is float32 or bfloat16; the reductions read it as it is and
sum in float32. A CUDA tensor goes to the kernels (`ops/cuda/bn.py`), a CPU
tensor to their plain versions; the normalize and dx passes are plain
PyTorch on both, as the JAX package computes them outside Pallas too.

At bfloat16 this is the arithmetic of the JAX package's Pallas arm
(`cpcsv_tpu/ops/batchnorm.py`, BN_BACKEND "pallas"): statistics and
normalize in float32, only the output rounded. Its default flax arm
(BN_BACKEND "xla", which the bfloat16 configs run) computes the same
formula with the statistics summed in another order, so the two differ
by float32 rounding, which later bfloat16 roundings can carry further.
The output's cast is inside the autograd Function, so the backward reads
a bfloat16 dy: the values of JAX's float32 cotangent of the cast, at half
the bytes.
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
    """(x (N, C, ...), scale [C], bias [C]) -> (y in x's dtype, mean, var)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x3 = x.reshape(x.shape[0], x.shape[1], -1).contiguous()
        M = x3.shape[0] * x3.shape[2]
        s, q = bn_stats(x3)
        mean = s / M
        var = torch.clamp(q / M - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (bn_cuda.upcast(x3) - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]
        ctx.save_for_backward(x3, scale, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype).view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x3, scale, mean, inv = ctx.saved_tensors
        dy3 = dy.reshape(x3.shape).contiguous()
        M = x3.shape[0] * x3.shape[2]
        sdy, sdyx = bn_grad_reduce(x3, dy3, mean, inv)
        xhat = (bn_cuda.upcast(x3) - mean[:, None]) * inv[:, None]
        dx = (scale * inv)[:, None] * (bn_cuda.upcast(dy3) - (sdy / M)[:, None]
                                       - xhat * (sdyx / M)[:, None])
        return dx.to(x3.dtype).view(dy.shape), sdyx, sdy, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BN of float32 or bfloat16 x (N, C), (N, C, H, W) or
    (N, C, T, H, W) with batch statistics: (y in x's dtype, batch mean,
    biased batch var), the statistics float32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"train-mode BatchNorm takes float32 or bfloat16, got {x.dtype}")
    return _BatchNormTrain.apply(x, scale, bias, eps)


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, M: int) -> None:
    """In place: ra = 0.9·ra + 0.1·batch, the variance Bessel-corrected."""
    bessel = M / max(M - 1, 1)
    running_mean.mul_(1.0 - MOMENTUM).add_(mean, alpha=MOMENTUM)
    running_var.mul_(1.0 - MOMENTUM).add_(var * bessel, alpha=MOMENTUM)
