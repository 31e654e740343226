"""Batched dynamic-filter 1-D convolution, the "Text2Gist" fusion op.

Counterpart of `cpcsv_tpu/ops/dynamic_filter.py`. Semantics (cross-correlation,
like torch F.conv1d, one filter bank per sample):

    out[b, o, x] = sum_{c,k} pad(image)[b, c, x + k] * filters[b, o, c, k]

A CUDA tensor always goes to the hand-written kernel (`ops/cuda/dfn.py`),
which raises for what it does not take (O != 1, other dtypes). The plain
version below serves CPU tensors only.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda


def dynamic_filter_conv1d_plain(
    image: torch.Tensor, filters: torch.Tensor, pad: int
) -> torch.Tensor:
    """image (B, C, L), filters (B, O, C, K) -> (B, O, L + 2*pad - K + 1):
    pad, unfold the K taps, one einsum. Any O."""
    K = filters.shape[-1]
    taps = F.pad(image, (pad, pad)).unfold(2, K, 1)  # (B, C, L_out, K)
    return torch.einsum("bcxk,bock->box", taps, filters)


def dynamic_filter_conv1d(image: torch.Tensor, filters: torch.Tensor, pad: int) -> torch.Tensor:
    if image.is_cuda:
        return dfn_cuda.dfn_forward(image, filters, pad)
    if image.device.type != "cpu":
        raise ValueError(f"dynamic_filter_conv1d runs on CUDA or the CPU, got {image.device}")
    return dynamic_filter_conv1d_plain(image, filters, pad)
