"""GRU unroll over the frames (counterpart of `cpcsv_tpu/ops/gru.py`).

`nn.GRUCell` has the JAX cell's math and the reference's parameter layout:
stacked weights in gate order [r | z | n],

    r = sigmoid(x W_irᵀ + b_ir + h W_hrᵀ + b_hr)
    z = sigmoid(x W_izᵀ + b_iz + h W_hzᵀ + b_hz)
    n = tanh(x W_inᵀ + b_in + r * (h W_hnᵀ + b_hn))
    h' = (1 - z) * n + z * h

T (VIDEO_LEN, 4 or 5) is small and fixed, so the unroll is a plain loop.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def gru_unroll(cell: nn.GRUCell, h0: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """xs (B, T, I), h0 (B, H) -> hs (B, T, H)."""
    hs = []
    h = h0
    for t in range(xs.shape[1]):
        h = cell(xs[:, t], h)
        hs.append(h)
    return torch.stack(hs, dim=1)
