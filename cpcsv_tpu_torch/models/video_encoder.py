"""Order-consistency video encoder, NCDHW inside (counterpart of
`cpcsv_tpu/models/video_encoder.py`; reference `VideoEncoder` /
`R2Plus1dStem`, `model.py:99-210`).

A stack of factorized (1,k,k) spatial / (k,1,1) temporal spectral-normed 3-D
convs, each followed by BN and an activation, a global average pool, and a
two-layer spectral-normed MLP that scores whether a story's frames were
shuffled. Module names are the reference's, the ones
`cpcsv_tpu/utils/port_torch.py:port_video_encoder_state_dict` reads:

  story_encoder.0      = R2Plus1dStem: .0 SN conv (1,7,7)/(1,2,2), .1 BN3d,
                         ReLU, .3 SN conv (1,1,1), .4 BN3d, ReLU
  story_encoder.{1+3i} = body SN conv i, .{2+3i} its BN3d, then LeakyReLU(0.2)
  detector             = .0 SN Linear(512, 128), .1 BN1d, ReLU, .3 SN Linear(128, 1)

The stem's second conv has kernel (1,1,1) but pads T by 1 on both sides, so
T grows by 2 (5 frames -> 7), as in the reference and the JAX package
(`video_encoder.py:60-63`). At ST_BATCH 18 the eleven BNs see (N, C, T·H·W)
maps from (18, 45, 5120) down to (18, 512, 4), and the detector's (18, 128, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cpcsv_tpu_torch.ops.blocks import BatchNorm1d, BatchNorm3d
from cpcsv_tpu_torch.ops.spectral_norm import SNConv3d, SNLinear

LEAK = 0.2
# (out channels, kernel (t, h, w), stride, padding) of the 8 body convs
# (`cpcsv_tpu/models/video_encoder.py:_BODY`, reference model.py:156-190)
BODY = (
    (128, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    (128, (3, 1, 1), (2, 1, 1), (1, 0, 0)),
    (128, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    (256, (3, 1, 1), (2, 1, 1), (1, 0, 0)),
    (256, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    (512, (3, 1, 1), (2, 1, 1), (1, 0, 0)),
    (512, (1, 3, 3), (1, 2, 2), (0, 1, 1)),
    (512, (3, 1, 1), (2, 1, 1), (1, 0, 0)),
)


class VideoEncoder(nn.Module):
    """Stories (B, T, H, W, 3) -> order logits (B, 1), in the compute dtype."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        stem = nn.Sequential(
            SNConv3d(3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), dtype=dtype),
            BatchNorm3d(45),
            nn.ReLU(),
            SNConv3d(45, 64, (1, 1, 1), (1, 1, 1), (1, 0, 0), dtype=dtype),
            BatchNorm3d(64),
            nn.ReLU(),
        )
        layers, width = [stem], 64
        for out, kernel, stride, pad in BODY:
            layers += [SNConv3d(width, out, kernel, stride, pad, dtype=dtype),
                       BatchNorm3d(out), nn.LeakyReLU(LEAK)]
            width = out
        self.story_encoder = nn.Sequential(*layers)
        self.detector = nn.Sequential(
            SNLinear(width, 128, dtype=dtype),
            BatchNorm1d(128),
            nn.ReLU(),
            SNLinear(128, 1, dtype=dtype),
        )

    def forward(self, story: torch.Tensor) -> torch.Tensor:
        x = self.story_encoder(story.permute(0, 4, 1, 2, 3).contiguous())
        return self.detector(x.mean(dim=(2, 3, 4)))
