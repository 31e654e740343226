"""GRU unroll over the frames (counterpart of `cpcsv_tpu/ops/gru.py`).

`nn.GRUCell` holds the parameters in the reference's layout: stacked weights
in gate order [r | z | n]. The step is the JAX cell's math, written out so
that it runs at the compute dtype as the JAX cell does
(`cpcsv_tpu/ops/gru.py:55-65`): the input, the state, the weights and the
biases cast to `dtype`, each product and its bias added in `dtype`, the gates
in `dtype`:

    xg = x W_ihᵀ + b_ih        hg = h W_hhᵀ + b_hh
    r = sigmoid(xg_r + hg_r)   z = sigmoid(xg_z + hg_z)
    n = tanh(xg_n + r * hg_n)
    h' = (1 - z) * n + z * h

T (VIDEO_LEN, 4 or 5) is small and fixed, so the unroll is a plain loop.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cpcsv_tpu_torch.ops.blocks import cast


def gru_unroll(cell: nn.GRUCell, h0: torch.Tensor, xs: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """xs (B, T, I), h0 (B, H) -> hs (B, T, H) in `dtype` (None: the
    parameters' dtype, float32)."""
    w_ih, w_hh = cast(cell.weight_ih, dtype), cast(cell.weight_hh, dtype)
    b_ih, b_hh = cast(cell.bias_ih, dtype), cast(cell.bias_hh, dtype)
    xs = cast(xs, dtype)
    hs = []
    h = h0
    for t in range(xs.shape[1]):
        xr, xz, xn = (F.linear(xs[:, t], w_ih) + b_ih).chunk(3, dim=-1)
        hr, hz, hn = (F.linear(cast(h, dtype), w_hh) + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)
