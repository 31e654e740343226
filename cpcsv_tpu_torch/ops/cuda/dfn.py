"""Wrappers of the CUDA dynamic-filter kernels (`csrc/dfn.cu`).

`dfn_forward` replaces `cpcsv_tpu/ops/pallas/dfn.py:dfn_pallas`;
`dfn_backward` computes its gradients, which the JAX package leaves to XLA.
One warp computes one sample (forward) or one (sample, channel) (backward);
`plan` picks the warps a block, the grid, the load width and the
compile-time instantiation from the shape, the SM count and the inputs'
alignment, and each launch gets them as ints. The library is built at the
first call (`build.py`), never at import. `launches` counts each kernel's
launches, a CUDA graph's replays included (`launches.py`), so that a run can
show its path went through them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from cpcsv_tpu_torch.ops.cuda import build
from cpcsv_tpu_torch.ops.cuda.launches import count

SOURCE = "cpcsv_tpu_torch/csrc/dfn.cu"
REPLACES = "cpcsv_tpu/ops/pallas/dfn.py:63"  # dfn_pallas, body _dfn_kernel at :35
# the backward has no Pallas kernel: it replaces XLA's gradient of the einsum path
REPLACES_BACKWARD = "cpcsv_tpu/ops/dynamic_filter.py:58"
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
GRID_MAX = 2**31 - 1  # blocks a 1-D grid may have
# csrc/dfn.cu's constants: lanes a warp, adjacent outputs a lane (kR), the
# outputs of one warp pass (kChunk); the most warps a block that plan picks
LANES, OUTPUTS_PER_LANE = 32, 4
CHUNK = LANES * OUTPUTS_PER_LANE
MAX_WARPS = 8
# (C, K) with a compile-time instantiation in csrc/dfn.cu; any other shape
# runs its runtime-K kernel (taps = 0)
INSTANTIATIONS = ((3, 21), (3, 7))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"dfn_forward": 0, "dfn_backward": 0}
_sm_counts: dict[int, int] = {}


class Plan(NamedTuple):
    """What one launch of `csrc/dfn.cu` does, as the kernel gets it; the
    kernel refuses a plan that does not fit the shape."""

    warps: int  # warps a block, one sample (forward) or (sample, channel) each
    grid: int  # blocks, 1-D
    vec: int  # image elements a load: 4 (16 bytes in float32) or 1
    taps: int  # K of the compile-time instantiation, 0 for runtime K


def _round4(n: int) -> int:
    return (n + 3) & ~3


def warp_floats(C: int, L: int, K: int, pad: int, backward: bool) -> int:
    """Floats of shared memory one warp stages (csrc/dfn.cu:layout): the
    forward C zero-padded rows and the C·K taps; the backward one row, the
    zero-padded dout and the K taps."""
    L_out = L + 2 * pad - K + 1
    row = -(-L_out // CHUNK) * CHUNK + _round4(K + 3)
    if not backward:
        return C * row + _round4(C * K)
    front = K - 1 - pad
    og = front if front >= 0 else front % 4
    db = og - front
    reach = max(og + -(-L_out // CHUNK) * CHUNK, db + -(-L // CHUNK) * CHUNK)
    return row + _round4(reach + K + 3) + _round4(K)


def plan(B: int, C: int, L: int, K: int, pad: int, sms: int, aligned: bool,
         backward: bool = False) -> Plan:
    """The launch for B samples of C rows of L (K taps, `pad`) on a card of
    `sms` SMs, `aligned` when the image starts on a 16-byte boundary (8 for
    bfloat16). The items, B (forward) or B·C (backward), one a warp, spread
    over the SMs: a block takes ceil(items / sms) warps, at most MAX_WARPS
    and as many as its shared memory holds."""
    if min(B, C, L, K, sms) < 1 or pad < 0 or L + 2 * pad - K + 1 < 1:
        raise ValueError(f"plan: B={B}, C={C}, L={L}, K={K}, pad={pad} on {sms} SMs")
    items = B * C if backward else B
    per_warp = 4 * warp_floats(C, L, K, pad, backward)
    if per_warp > SMEM_LIMIT:
        raise ValueError(f"C={C}, L={L}, K={K}, pad={pad} exceed one block's shared memory")
    warps = min(MAX_WARPS, -(-items // sms), SMEM_LIMIT // per_warp)
    grid = -(-items // warps)
    if grid > GRID_MAX:
        raise ValueError(f"plan: {items} items need {grid} blocks")
    vec = 4 if aligned and L % 4 == 0 else 1
    taps = K if (C, K) in INSTANTIATIONS else 0
    return Plan(warps, grid, vec, taps)


def _library() -> ctypes.CDLL:
    lib = build.load("dfn")
    if lib.dfn_forward.argtypes is None:  # pointers and the stream as c_void_p, not 32-bit ints
        lib.dfn_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.dfn_forward.restype = ctypes.c_int
        lib.dfn_backward.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                     + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.dfn_backward.restype = ctypes.c_int
    return lib


def _call(fn, device: torch.device, *args) -> int:
    """fn(*args, stream) on `device`'s current stream; returns its error code."""
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def _check(image: torch.Tensor, filters: torch.Tensor, pad: int, name: str, dtypes) -> int:
    """Validates image (B, C, L) and filters (B, 1, C, K); returns L_out."""
    if not (image.is_cuda and filters.is_cuda) or image.device != filters.device:
        raise ValueError(f"{name} takes tensors on one CUDA device")
    if image.dtype not in dtypes or filters.dtype != image.dtype:
        raise TypeError(f"{name} takes {' or '.join(map(str, dtypes))} of one dtype, "
                        f"got {image.dtype} and {filters.dtype}")
    if image.dim() != 3 or filters.dim() != 4:
        raise ValueError(f"expected image (B, C, L) and filters (B, O, C, K), got "
                         f"{tuple(image.shape)} and {tuple(filters.shape)}")
    B, C, L = image.shape
    Bf, O, Cf, K = filters.shape
    if O != 1:
        raise NotImplementedError(f"the CUDA dynamic-filter kernels take O = 1 filters, got O = {O}")
    if Bf != B or Cf != C:
        raise ValueError(f"image {tuple(image.shape)} and filters {tuple(filters.shape)} disagree")
    L_out = L + 2 * pad - K + 1
    if B < 1 or pad < 0 or L_out < 1:
        raise ValueError(f"empty dynamic-filter conv: B={B}, L={L}, K={K}, pad={pad}")
    if not (image.is_contiguous() and filters.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    return L_out


def _plan(image: torch.Tensor, K: int, pad: int, backward: bool) -> Plan:
    """The plan for this image on its card, whose SM count is read once."""
    index = image.device.index
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return plan(*image.shape, K, pad, _sm_counts[index],
                image.data_ptr() % (4 * image.element_size()) == 0, backward)


def dfn_forward(image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    """image (B, C, L), filters (B, 1, C, K), both CUDA, float32 or bfloat16
    -> (B, 1, L + 2*pad - K + 1) in the input dtype."""
    _check(image, filters, pad, "dfn_forward", tuple(_DTYPES))
    return launch_forward(_plan(image, filters.shape[-1], pad, False), image, filters, pad)


def launch_forward(p: Plan, image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    """One launch of the forward kernel under plan `p` on inputs that
    `dfn_forward` would take, on the current stream; counts it."""
    B, C, L = image.shape
    K = filters.shape[-1]
    out = torch.empty((B, 1, L + 2 * pad - K + 1), dtype=image.dtype, device=image.device)
    err = _call(_library().dfn_forward, image.device, image.data_ptr(), filters.data_ptr(),
                out.data_ptr(), B, C, L, K, pad, _DTYPES[image.dtype], *p)
    if err != 0:
        raise RuntimeError(f"dfn_forward launch failed with CUDA error {err} ({p})")
    count(launches, "dfn_forward")
    return out


def dfn_backward(
    image: torch.Tensor, filters: torch.Tensor, dout: torch.Tensor, pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `dfn_forward` at (image, filters) for the output gradient
    dout (B, 1, L_out): (d image (B, C, L), d filters (B, 1, C, K)), all of
    one dtype, float32 or bfloat16, summed in float32. dout's rows may lie
    any distance apart (a column slice of a wider buffer), with unit stride
    along L_out."""
    L_out = _check(image, filters, pad, "dfn_backward", tuple(_DTYPES))
    B = image.shape[0]
    if dout.shape != (B, 1, L_out) or dout.dtype != image.dtype or dout.device != image.device:
        raise ValueError(f"dfn_backward: dout must be {image.dtype} {(B, 1, L_out)} on "
                         f"{image.device}, got {dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if dout.stride(-1) != 1:
        raise ValueError(f"dfn_backward takes dout with unit stride along L_out, got strides "
                         f"{dout.stride()}")
    return launch_backward(_plan(image, filters.shape[-1], pad, True), image, filters, dout, pad)


def launch_backward(p: Plan, image: torch.Tensor, filters: torch.Tensor, dout: torch.Tensor,
                    pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel under plan `p` on inputs that
    `dfn_backward` would take, on the current stream; counts it."""
    B, C, L = image.shape
    dimage = torch.empty_like(image)
    dfilters = torch.empty_like(filters)
    err = _call(_library().dfn_backward, image.device, image.data_ptr(), filters.data_ptr(),
                dout.data_ptr(), dimage.data_ptr(), dfilters.data_ptr(), B, C, L,
                filters.shape[-1], pad, dout.stride(0), _DTYPES[image.dtype], *p)
    if err != 0:
        raise RuntimeError(f"dfn_backward launch failed with CUDA error {err} ({p})")
    count(launches, "dfn_backward")
    return dimage, dfilters
