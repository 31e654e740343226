"""Wrappers of the CUDA BatchNorm reduction kernels (`csrc/bn.cu`), and their
plain PyTorch versions.

`bn_stats` replaces `cpcsv_tpu/ops/pallas/bn.py:bn_stats` and
`bn_grad_reduce` replaces `bn_grad_reduce` there. Both take the port's NCHW
activations as an (N, C, S) view (S = H*W; S = 1 for BatchNorm1d), float32
or bfloat16 as the Pallas kernels do, and return per-channel sums in
float32, in one launch per call whose grid, cluster and load width `plan`
chooses from the shape, the element size, the SM count and the inputs'
alignment. The library is built at the first call (`build.py`), never at
import. `launches` counts each kernel's launches, a CUDA graph's replays
included (`launches.py`). The plain versions serve
CPU tensors; on the card they are only the yardstick the kernels are held
against.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from cpcsv_tpu_torch.ops.cuda import build
from cpcsv_tpu_torch.ops.cuda.launches import count

SOURCE = "cpcsv_tpu_torch/csrc/bn.cu"
REPLACES = {
    "bn_stats": "cpcsv_tpu/ops/pallas/bn.py:66",  # body _stats_kernel at :52
    "bn_grad_reduce": "cpcsv_tpu/ops/pallas/bn.py:106",  # body _grad_kernel at :91
}
# csrc/bn.cu's constants: a block's threads (kThreads), reduce_rows'
# channels a block (kRowChannels), the fewest loads a reduce_maps thread
# starts at once (kUnroll<true>; bn_stats starts 8), the portable cluster
# size, the bytes of a vector load
THREADS, ROW_CHANNELS, UNROLL, MAX_CLUSTER, LOAD_BYTES = 256, 32, 4, 8, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # csrc/bn.cu's dtype codes
# reduce_maps' blocks an SM should get: measured on an H100, more and
# smaller blocks, or clusters where C alone gives every SM a block, cost
# more in launch and reduction than they add in bytes in flight
BLOCKS_PER_SM = 2
GRID_MAX = 2**31 - 1  # blocks a 1-D grid may have

launches = {"bn_stats": 0, "bn_grad_reduce": 0}
_sm_counts: dict[int, int] = {}


class Plan(NamedTuple):
    """What one launch of `csrc/bn.cu` does, as the kernel gets it: reduce_rows
    if S == 1, else reduce_maps; the kernel refuses a plan that does not fit
    the shape."""

    vec: int  # elements a load: 16 bytes (4 float32, 8 bfloat16) or 1
    grid: int  # blocks, 1-D
    cluster: int  # blocks of one thread block cluster that share a channel (maps), else 1
    channels: int  # channels a block reduces (with cluster > 1: a cluster)


def plan(N: int, C: int, S: int, sms: int, aligned: bool, itemsize: int = 4) -> Plan:
    """The launch for an (N, C, S) reduction of `itemsize`-byte elements
    (4: float32, 2: bfloat16) on a card of `sms` SMs, `aligned` when every
    input starts on a 16-byte boundary. Loads are LOAD_BYTES wide where the
    row length allows, so the work is sized in 16-byte loads: half as many
    for bfloat16 as for float32 of the same shape.

    S = 1: reduce_rows, ROW_CHANNELS channels a block, as 16-byte loads over
    32 (float32) or 64 (bfloat16) row groups, or elements over 8. S > 1:
    reduce_maps, about BLOCKS_PER_SM blocks an SM: a channel gets
    BLOCKS_PER_SM·sms·THREADS / C threads, but no more than leaves each
    thread UNROLL loads. Up to a block that rounds to a power of two, from a
    warp (and 8 channels a block) to a block; beyond, to a cluster of up to
    MAX_CLUSTER blocks."""
    if min(N, C, S, sms) < 1 or itemsize not in (2, 4):
        raise ValueError(f"plan: (N, C, S) = {(N, C, S)}, {itemsize}-byte elements on {sms} SMs")
    wide = LOAD_BYTES // itemsize
    if S == 1:
        vec = wide if aligned and C % wide == 0 else 1
        return Plan(vec, -(-C // ROW_CHANNELS), 1, ROW_CHANNELS)
    vec = wide if aligned and S % wide == 0 else 1
    items = N * (S // vec)  # loads a channel needs
    want = min(-(-sms * BLOCKS_PER_SM * THREADS // C), -(-items // UNROLL))  # threads a channel
    if want > THREADS:
        tpc, cluster = THREADS, min(MAX_CLUSTER, int(want / THREADS + 0.5))
    else:
        tpc, cluster = max(32, 1 << int(math.log2(want) + 0.5)), 1
    channels = THREADS // tpc
    grid = -(-C // channels) * cluster
    if grid > GRID_MAX:
        raise ValueError(f"plan: (N, C, S) = {(N, C, S)} needs {grid} blocks")
    return Plan(vec, grid, cluster, channels)


def _library() -> ctypes.CDLL:
    lib = build.load("bn")
    if lib.bn_stats.argtypes is None:  # pointers and the stream as c_void_p, not 32-bit ints
        lib.bn_stats.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.bn_stats.restype = ctypes.c_int
        lib.bn_grad_reduce.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.bn_grad_reduce.restype = ctypes.c_int
    return lib


def _check(name: str, *tensors: torch.Tensor) -> tuple[int, int, int]:
    x = tensors[0]
    if x.dim() != 3:
        raise ValueError(f"{name} takes an (N, C, S) view, got shape {tuple(x.shape)}")
    for t in tensors:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} takes tensors on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    N, C, S = x.shape
    if not all(1 <= n < 2**31 for n in x.shape):  # each goes to the kernel as an int
        raise ValueError(f"{name}: shape {tuple(x.shape)} out of range")
    return N, C, S


def _plan(*inputs: torch.Tensor) -> Plan:
    """The launch for these (N, C, S) inputs on their card, whose SM count
    is read once."""
    index = inputs[0].device.index
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return plan(*inputs[0].shape, _sm_counts[index],
                all(t.data_ptr() % LOAD_BYTES == 0 for t in inputs), inputs[0].element_size())


def bn_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, C, S) float32 or bfloat16 on the card -> (sum x, sum x²),
    float32 [C], summed in float32."""
    _check("bn_stats", x)
    return launch("bn_stats", _plan(x), x)


def bn_grad_reduce(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x, dy (N, C, S), float32 or bfloat16 (one dtype), and mean, invstd
    [C] float32, on the card -> (sum dy, sum dy·xhat), float32 [C], summed in
    float32, with xhat = (x − mean)·invstd."""
    N, C, S = _check("bn_grad_reduce", x, dy, mean, invstd)
    if dy.dtype != x.dtype or mean.dtype != torch.float32 or invstd.dtype != torch.float32:
        raise TypeError(f"bn_grad_reduce takes x and dy of one dtype and float32 mean and "
                        f"invstd, got {x.dtype}, {dy.dtype}, {mean.dtype}, {invstd.dtype}")
    if dy.shape != x.shape or mean.shape != (C,) or invstd.shape != (C,):
        raise ValueError(f"bn_grad_reduce: x {tuple(x.shape)}, dy {tuple(dy.shape)}, mean "
                         f"{tuple(mean.shape)}, invstd {tuple(invstd.shape)} disagree")
    return launch("bn_grad_reduce", _plan(x, dy), x, dy, mean, invstd)


def launch(name: str, p: Plan, *inputs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of kernel `name` under plan `p` on inputs that `bn_stats`
    or `bn_grad_reduce` would take, on the current stream; counts it."""
    x = inputs[0]
    N, C, S = x.shape
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in inputs), out[0].data_ptr(),
                                 out[1].data_ptr(), N, C, S, _DTYPES[x.dtype], p.vec, p.grid,
                                 p.cluster, p.channels, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err} ({p})")
    count(launches, name)
    return out[0], out[1]


def upcast(t: torch.Tensor) -> torch.Tensor:
    """t in the dtype BN sums and normalizes in: float32, or wider if t is."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def bn_stats_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_stats`, any device, summed in float32 (or in x's
    dtype where that is wider)."""
    x = upcast(x)
    return x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2))


def bn_grad_reduce_plain(
    x: torch.Tensor, dy: torch.Tensor, mean: torch.Tensor, invstd: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `bn_grad_reduce`, any device, summed in float32 (or
    in the inputs' dtype where that is wider)."""
    dy = upcast(dy)
    xhat = (upcast(x) - mean[:, None]) * invstd[:, None]
    return dy.sum(dim=(0, 2)), (dy * xhat).sum(dim=(0, 2))
