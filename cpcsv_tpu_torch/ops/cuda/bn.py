"""Wrappers of the CUDA BatchNorm reduction kernels (`csrc/bn.cu`), and their
plain PyTorch versions.

`bn_stats` replaces `cpcsv_tpu/ops/pallas/bn.py:bn_stats` and
`bn_grad_reduce` replaces `bn_grad_reduce` there. Both take the port's NCHW
activations as an (N, C, S) view (S = H*W; S = 1 for BatchNorm1d) and return
per-channel float32 sums. The library is built at the first call
(`build.py`), never at import. `launches` counts each kernel's launches. The
plain versions serve CPU tensors; on the card they are only the yardstick
the kernels are held against.
"""

from __future__ import annotations

import ctypes

import torch

from cpcsv_tpu_torch.ops.cuda import build

SOURCE = "cpcsv_tpu_torch/csrc/bn.cu"
REPLACES = {
    "bn_stats": "cpcsv_tpu/ops/pallas/bn.py:66",  # body _stats_kernel at :52
    "bn_grad_reduce": "cpcsv_tpu/ops/pallas/bn.py:106",  # body _grad_kernel at :91
}
ROWS_PER_BLOCK_ELEMENTS = 8192  # elements of one channel a block reduces, at least

launches = {"bn_stats": 0, "bn_grad_reduce": 0}


def _library() -> ctypes.CDLL:
    lib = build.load("bn")
    if lib.bn_stats.argtypes is None:  # pointers and the stream as c_void_p, not 32-bit ints
        lib.bn_stats.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.bn_stats.restype = ctypes.c_int
        lib.bn_grad_reduce.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.bn_grad_reduce.restype = ctypes.c_int
    return lib


def chunks(N: int, S: int) -> int:
    """P, the blocks each channel's N rows are split over: one block per
    ~8,192 elements of a channel, so that the largest maps of the step,
    (90, 128, 64*64), fill the card with 5,760 blocks, while the short ones
    keep one block, and no second pass, per channel. S = 1 takes P = 1."""
    if S == 1:
        return 1
    return max(1, min(N, N * S // ROWS_PER_BLOCK_ELEMENTS))


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int, int]:
    x = tensors[0]
    if x.dim() != 3:
        raise ValueError(f"{name} takes an (N, C, S) view, got shape {tuple(x.shape)}")
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    N, C, S = x.shape
    if not all(1 <= n < 2**31 for n in x.shape):  # each goes to the kernel as an int
        raise ValueError(f"{name}: shape {tuple(x.shape)} out of range")
    return N, C, S


def _outputs(x: torch.Tensor, C: int, P: int):
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    partial = torch.empty((2, C, P), dtype=torch.float32, device=x.device) if P > 1 else None
    return out, partial


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, C, S) float32 on the card -> (sum x, sum x²), float32 [C]."""
    N, C, S = _check("bn_stats", x)
    P = chunks(N, S)
    out, partial = _outputs(x, C, P)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bn_stats(x.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                           partial.data_ptr() if partial is not None else None,
                           N, C, S, P, stream)
    if err != 0:
        raise RuntimeError(f"bn_stats launch failed with CUDA error {err}")
    launches["bn_stats"] += 1
    return out[0], out[1]


def bn_grad_reduce(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dy (N, C, S) and mean, invstd [C], float32 on the card ->
    (sum dy, sum dy·xhat), float32 [C], with xhat = (x − mean)·invstd."""
    N, C, S = _check("bn_grad_reduce", x, dy, mean, invstd)
    if dy.shape != x.shape or mean.shape != (C,) or invstd.shape != (C,):
        raise ValueError(f"bn_grad_reduce: x {tuple(x.shape)}, dy {tuple(dy.shape)}, mean "
                         f"{tuple(mean.shape)}, invstd {tuple(invstd.shape)} disagree")
    P = chunks(N, S)
    out, partial = _outputs(x, C, P)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bn_grad_reduce(x.data_ptr(), dy.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
                                 out[0].data_ptr(), out[1].data_ptr(),
                                 partial.data_ptr() if partial is not None else None,
                                 N, C, S, P, stream)
    if err != 0:
        raise RuntimeError(f"bn_grad_reduce launch failed with CUDA error {err}")
    launches["bn_grad_reduce"] += 1
    return out[0], out[1]


def bn_stats_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_stats`, any device, in the input's dtype."""
    return x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2))


def bn_grad_reduce_plain(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_grad_reduce`, any device, in the inputs' dtype."""
    xhat = (x - mean[:, None]) * invstd[:, None]
    return dy.sum(dim=(0, 2)), (dy * xhat).sum(dim=(0, 2))
