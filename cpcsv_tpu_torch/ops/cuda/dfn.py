"""Wrappers of the CUDA dynamic-filter kernels (`csrc/dfn.cu`).

`dfn_forward` replaces `cpcsv_tpu/ops/pallas/dfn.py:dfn_pallas`;
`dfn_backward` computes its gradients, which the JAX package leaves to XLA.
The library is built at the first call (`build.py`), never at import.
`launches` counts each kernel's launches, so that a run can show its path
went through them.
"""

from __future__ import annotations

import ctypes

import torch

from cpcsv_tpu_torch.ops.cuda import build

SOURCE = "cpcsv_tpu_torch/csrc/dfn.cu"
REPLACES = "cpcsv_tpu/ops/pallas/dfn.py:63"  # dfn_pallas, body _dfn_kernel at :35
# the backward has no Pallas kernel: it replaces XLA's gradient of the einsum path
REPLACES_BACKWARD = "cpcsv_tpu/ops/dynamic_filter.py:58"
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"dfn_forward": 0, "dfn_backward": 0}


def _library() -> ctypes.CDLL:
    lib = build.load("dfn")
    if lib.dfn_forward.argtypes is None:  # pointers and the stream as c_void_p, not 32-bit ints
        lib.dfn_forward.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.dfn_forward.restype = ctypes.c_int
        lib.dfn_backward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.dfn_backward.restype = ctypes.c_int
    return lib


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
    if 4 * (C * (L + 2 * pad + K) + L_out + 2 * K) > SMEM_LIMIT:
        raise ValueError(f"C={C}, L={L}, K={K}, pad={pad} exceed one block's shared memory")
    if not (image.is_contiguous() and filters.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    return L_out


def dfn_forward(image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    """image (B, C, L), filters (B, 1, C, K), both CUDA, float32 or bfloat16
    -> (B, 1, L + 2*pad - K + 1) in the input dtype."""
    L_out = _check(image, filters, pad, "dfn_forward", tuple(_DTYPES))
    B, C, L = image.shape
    out = torch.empty((B, 1, L_out), dtype=image.dtype, device=image.device)
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfn_forward(
            image.data_ptr(), filters.data_ptr(), out.data_ptr(),
            B, C, L, filters.shape[-1], pad, _DTYPES[image.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"dfn_forward launch failed with CUDA error {err}")
    launches["dfn_forward"] += 1
    return out


def dfn_backward(
    image: torch.Tensor, filters: torch.Tensor, dout: torch.Tensor, pad: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients of `dfn_forward` at (image, filters) for the output gradient
    dout (B, 1, L_out): (d image (B, C, L), d filters (B, 1, C, K)), float32."""
    L_out = _check(image, filters, pad, "dfn_backward", (torch.float32,))
    B, C, L = image.shape
    if dout.shape != (B, 1, L_out) or dout.dtype != torch.float32 or dout.device != image.device:
        raise ValueError(f"dfn_backward: dout must be float32 {(B, 1, L_out)} on {image.device}, "
                         f"got {dout.dtype} {tuple(dout.shape)} on {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("dfn_backward takes contiguous tensors")
    dimage = torch.empty_like(image)
    dfilters = torch.empty_like(filters)
    lib = _library()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dfn_backward(
            image.data_ptr(), filters.data_ptr(), dout.data_ptr(), dimage.data_ptr(),
            dfilters.data_ptr(), B, C, L, filters.shape[-1], pad, stream,
        )
    if err != 0:
        raise RuntimeError(f"dfn_backward launch failed with CUDA error {err}")
    launches["dfn_backward"] += 1
    return dimage, dfilters
