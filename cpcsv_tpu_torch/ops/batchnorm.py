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

Under REMAT (`models/generator.py`) the backward runs a block's forward a
second time, its BN on the same input through the same kernel, which gives
the forward's bits (the kernels have no atomics). Inside `recomputing()` a
BN computes as before but writes no state, so the running statistics and
`num_batches_tracked` are updated once a call, as flax's remat does.

In a process group (`parallel/`) the statistics are the global batch's, as
the JAX package's one SPMD program computes them over the sharded batch.
Each rank's kernels reduce its own rows, and then, over the rank's data
group (`mesh.all_reduce_sum_`; the replicas on a mesh's other axes reduce
the same rows apart):

  * forward: (s, q) and the row count M are all-reduced in one call, one
    buffer of 2C + 1 floats. M is all-reduced, not taken as W × the local
    M: the wrong-pair head runs on B − 1 global rows split unevenly, and
    InfoNCE's head on B² rows as (B/W)·B a rank;
  * backward: (sdy, sdyx) are all-reduced before dx, which needs the global
    sums; dscale and dbias are returned as the LOCAL sdyx and sdy, because
    the gradient all-reduce of the step (`train/steps.py:_step`) sums every
    parameter's gradient once: returning the reduced sums would count them
    W times;
  * a rank whose local map has zero rows (the last rank's wrong-pair head
    at one row a rank) launches no kernel, contributes zero sums and still
    joins both collectives: a rank that skipped one would pair its next
    collective with another rank's this one, or hang;
  * REMAT's recompute runs the forward's all-reduce again, on every rank in
    the same order (autograd's order is the graph's), so it sees the
    forward's global statistics;
  * the running statistics update from the global mean and variance with
    the global M (`global_rows`), so they stay equal across ranks.

The global M is a tensor on the device (reading it on the host would stall
the host at every BN). Divided by it, the sums get the bits they get from
a Python int M in one process: on the CPU `t / M` is a true division either
way; on CUDA a division by a Python scalar is a multiplication by its
float32 reciprocal (`_per_row`). So a group of one rank computes what one
process does, bit for bit.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch

from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
from cpcsv_tpu_torch.parallel.distributed import is_distributed
from cpcsv_tpu_torch.parallel.mesh import all_reduce_sum_

MOMENTUM = 0.1
_recompute = threading.local()  # autograd runs a CUDA backward on a thread of its own
_rows = threading.local()  # the global M of this thread's last train-mode BN forward


@contextlib.contextmanager
def recomputing():
    """While it is open on this thread, train-mode BN updates no state."""
    was = is_recomputing()
    _recompute.on = True
    try:
        yield
    finally:
        _recompute.on = was


def is_recomputing() -> bool:
    return getattr(_recompute, "on", False)


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


def _per_row(t: torch.Tensor, M) -> torch.Tensor:
    """t / M for a Python int M; for the all-reduced M (a float32 1-element
    tensor on t's device), the same bits: CUDA divides by a Python scalar as a
    multiplication by its float32 reciprocal, the CPU truly divides."""
    if not torch.is_tensor(M) or not t.is_cuda:
        return t / M
    return t * torch.reciprocal(M)


def _global_sums(*parts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The parts summed over the process group, in one all-reduce of their
    concatenation."""
    buf = all_reduce_sum_(torch.cat(parts))
    return buf.split([p.numel() for p in parts])


class _BatchNormTrain(torch.autograd.Function):
    """(x (N, C, ...), scale [C], bias [C]) -> (y in x's dtype, mean, var)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        x3 = x.reshape(x.shape[0], x.shape[1], math.prod(x.shape[2:])).contiguous()
        M = x3.shape[0] * x3.shape[2]
        if x3.numel():
            s, q = bn_stats(x3)
        else:  # a rank's empty map: no launch, zero sums, the collective joined below
            s = q = torch.zeros(x3.shape[1], dtype=torch.float32, device=x3.device)
        if is_distributed():
            s, q, M = _global_sums(s, q, torch.full((1,), float(M), device=s.device))
            _rows.M = M
        mean = _per_row(s, M)
        var = torch.clamp(_per_row(q, M) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (bn_cuda.upcast(x3) - mean[:, None]) * (inv * scale)[:, None] + bias[:, None]
        ctx.save_for_backward(x3, scale, mean, inv, *((M,) if torch.is_tensor(M) else ()))
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype).view(x.shape), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x3, scale, mean, inv, *global_m = ctx.saved_tensors
        dy3 = dy.reshape(x3.shape).contiguous()
        M = global_m[0] if global_m else x3.shape[0] * x3.shape[2]
        if x3.numel():
            sdy, sdyx = bn_grad_reduce(x3, dy3, mean, inv)
        else:
            sdy = sdyx = torch.zeros_like(mean)
        # dscale and dbias stay this rank's sums: the step's gradient
        # all-reduce adds the ranks' once
        dscale, dbias = sdyx, sdy
        if global_m:
            sdy, sdyx = _global_sums(sdy, sdyx)
        xhat = (bn_cuda.upcast(x3) - mean[:, None]) * inv[:, None]
        dx = (scale * inv)[:, None] * (bn_cuda.upcast(dy3) - _per_row(sdy, M)[:, None]
                                       - xhat * _per_row(sdyx, M)[:, None])
        return dx.to(x3.dtype).view(dy.shape), dscale, dbias, None


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """Train-mode BN of float32 or bfloat16 x (N, C), (N, C, H, W) or
    (N, C, T, H, W) with batch statistics: (y in x's dtype, batch mean,
    biased batch var), the statistics float32."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"train-mode BatchNorm takes float32 or bfloat16, got {x.dtype}")
    return _BatchNormTrain.apply(x, scale, bias, eps)


def global_rows(x: torch.Tensor):
    """The rows M of the train-mode BN just run on `x` on this thread: the
    local N·S as an int, or in a process group the all-reduced M of that
    forward as a 1-element tensor."""
    if is_distributed():
        return _rows.M
    return x.numel() // x.shape[1]


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, M) -> None:
    """In place: ra = 0.9·ra + 0.1·batch, the variance Bessel-corrected. M is
    an int, or the global M as a 1-element tensor, whose factor M / max(M − 1, 1)
    is formed in float64 and rounded once to var's dtype, as a Python float
    multiplies a float32 (or float64) tensor."""
    if torch.is_tensor(M):
        m = M.double()
        bessel = (m / torch.clamp(m - 1, min=1)).to(var.dtype)
    else:
        bessel = M / max(M - 1, 1)
    running_mean.mul_(1.0 - MOMENTUM).add_(mean, alpha=MOMENTUM)
    running_var.mul_(1.0 - MOMENTUM).add_(var * bessel, alpha=MOMENTUM)
