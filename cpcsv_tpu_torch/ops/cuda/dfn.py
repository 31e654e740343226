"""Wrapper of the CUDA dynamic-filter kernel (`csrc/dfn.cu`).

Replaces `cpcsv_tpu/ops/pallas/dfn.py:dfn_pallas`, forward only. The library
is built at the first call (`build.py`), never at import. `launches` counts
the kernel's launches, so that a run can show its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from cpcsv_tpu_torch.ops.cuda import build

SOURCE = "cpcsv_tpu_torch/csrc/dfn.cu"
REPLACES = "cpcsv_tpu/ops/pallas/dfn.py:63"  # dfn_pallas, body _dfn_kernel at :35
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("dfn")
    fn = lib.dfn_forward
    if fn.argtypes is None:  # pointers and the stream as c_void_p, not 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def dfn_forward(image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    """image (B, C, L), filters (B, 1, C, K), both CUDA, float32 or bfloat16
    -> (B, 1, L + 2*pad - K + 1) in the input dtype."""
    global launches
    if torch.is_grad_enabled() and (image.requires_grad or filters.requires_grad):
        raise NotImplementedError(
            "the CUDA dynamic-filter kernel is forward only; its backward comes "
            "with the training slice of the port"
        )
    if not (image.is_cuda and filters.is_cuda) or image.device != filters.device:
        raise ValueError("dfn_forward takes two tensors on the same CUDA device")
    if image.dtype not in _DTYPES or filters.dtype != image.dtype:
        raise TypeError(
            f"dfn_forward takes float32 or bfloat16 of one dtype, got {image.dtype} and {filters.dtype}"
        )
    if image.dim() != 3 or filters.dim() != 4:
        raise ValueError(f"expected image (B, C, L) and filters (B, O, C, K), got "
                         f"{tuple(image.shape)} and {tuple(filters.shape)}")
    B, C, L = image.shape
    Bf, O, Cf, K = filters.shape
    if O != 1:
        raise NotImplementedError(f"the CUDA dynamic-filter kernel takes O = 1 filters, got O = {O}")
    if Bf != B or Cf != C:
        raise ValueError(f"image {tuple(image.shape)} and filters {tuple(filters.shape)} disagree")
    L_out = L + 2 * pad - K + 1
    if B < 1 or pad < 0 or L_out < 1:
        raise ValueError(f"empty dynamic-filter conv: B={B}, L={L}, K={K}, pad={pad}")
    if 4 * C * (L + 2 * pad + K) > SMEM_LIMIT:
        raise ValueError(f"C={C}, L={L}, K={K}, pad={pad} exceed one block's shared memory")
    if not (image.is_contiguous() and filters.is_contiguous()):
        raise ValueError("dfn_forward takes contiguous tensors")

    out = torch.empty((B, 1, L_out), dtype=image.dtype, device=image.device)
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfn_forward(
            image.data_ptr(), filters.data_ptr(), out.data_ptr(),
            B, C, L, K, pad, _DTYPES[image.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"dfn_forward launch failed with CUDA error {err}")
    launches += 1
    return out
