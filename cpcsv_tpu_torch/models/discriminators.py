"""The three conditional discriminators and their logit head, NCHW inside.

Counterpart of `cpcsv_tpu/models/discriminators.py`:
  * ImageDiscriminator  <- STAGE1_D_IMG    (reference `model.py:487-527`)
  * SegDiscriminator    <- STAGE1_D_SEG    (reference `model.py:529-569`)
  * StoryDiscriminator  <- STAGE1_D_STY_V2 (reference `model.py:571-618`)
  * DGetLogits          <- D_GET_LOGITS    (reference `model.py:68-97`)

Module names and parameter shapes are the reference's, the layout that
`cpcsv_tpu/utils/export_torch.py:191-223` writes, so a converted JAX state or
a reference `netD_*.pth` loads with ``load_state_dict(strict=True)``:

  encode_img      = Sequential(conv0, LReLU, SN conv, BN, LReLU, SN conv, BN,
                               LReLU, SN conv, BN, LReLU)  (conv0 SN on the story D)
  get_cond_logits.outlogits = Sequential(SN conv3x3, BN, LReLU, SN conv4x4/4)
  cate_classify   = Conv2d(ndf*8, labels, 4, 4, 1)           (image and seg D)

The heads return logits (no sigmoid). The public methods take the JAX
package's layouts: images (N, H, W, C), stories (B, T, H, W, C).
`d_phase` and `g_phase` call the encoder and the head in the JAX order,
which sets how the BN running statistics and the SN vectors evolve. There is
no VideoEncoder and no InfoNCE method yet (`models/factory.py` refuses
both).

`dtype` is the compute dtype (cfg.COMPUTE_DTYPE; None = float32): every conv
runs in it, with float32 parameters, so the features and logits come out in
it; the losses take the logits to float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cpcsv_tpu_torch.ops.blocks import BatchNorm2d, Conv2d, Conv4x4s2
from cpcsv_tpu_torch.ops.spectral_norm import SNConv2d

LEAK = 0.2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def encoder64(in_channels: int, ndf: int, sn_first: bool,
              dtype: Optional[torch.dtype] = None) -> nn.Sequential:
    """64x64 -> 4x4x(ndf*8): four 4x4 stride-2 convs with LeakyReLU(0.2);
    spectral norm on layers 2-4 (and on layer 1 for the story D)."""
    first = (SNConv2d(in_channels, ndf, 4, 2, 1, dtype=dtype) if sn_first
             else Conv4x4s2(in_channels, ndf, dtype))
    layers = [first, nn.LeakyReLU(LEAK)]
    for m_in, m_out in ((1, 2), (2, 4), (4, 8)):
        layers += [SNConv2d(ndf * m_in, ndf * m_out, 4, 2, 1, dtype=dtype),
                   BatchNorm2d(ndf * m_out), nn.LeakyReLU(LEAK)]
    return nn.Sequential(*layers)


class DGetLogits(nn.Module):
    """Conditional logit head: features (N, ndf*8, 4, 4) and conditions
    (N, nef) -> logits (N,)."""

    def __init__(self, ndf: int, nef: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ef_dim = nef
        self.outlogits = nn.Sequential(
            SNConv2d(ndf * 8 + nef, ndf * 8, 3, 1, 1, dtype=dtype),
            BatchNorm2d(ndf * 8),
            nn.LeakyReLU(LEAK),
            SNConv2d(ndf * 8, 1, 4, 4, 0, bias=True, dtype=dtype),
        )

    def forward(self, h_code: torch.Tensor, c_code: torch.Tensor) -> torch.Tensor:
        if c_code.shape[-1] != self.ef_dim:
            raise ValueError(f"condition width {c_code.shape[-1]} != nef={self.ef_dim} "
                             "(CONDITION_DIM + TEXT.DIMENSION + LABEL_NUM)")
        c = c_code[:, :, None, None].expand(-1, -1, *h_code.shape[2:])
        return self.outlogits(torch.cat([h_code, c.to(h_code.dtype)], dim=1)).reshape(-1)


class ImageDiscriminator(nn.Module):
    """STAGE1_D_IMG: frames (N, 64, 64, in_channels), a conditional head and
    a multi-label character head."""

    def __init__(self, ndf: int = 124, nef: int = 124, text_dim: int = 356,
                 label_num: int = 9, use_categories: bool = True, in_channels: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_channels, self.label_num = in_channels, label_num
        self.encode_img = encoder64(in_channels, ndf, sn_first=False, dtype=dtype)
        self.get_cond_logits = DGetLogits(ndf, nef + text_dim + label_num, dtype)
        self.cate_classify = (Conv2d(ndf * 8, label_num, 4, 4, 1, bias=False, dtype=dtype)
                              if use_categories else None)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) -> features (N, ndf*8, 4, 4)."""
        if image.shape[-1] != self.in_channels:
            # e.g. RGB frames fed to the 1-channel SegDiscriminator
            raise ValueError(f"{type(self).__name__} expects {self.in_channels}-channel "
                             f"input, got {image.shape[-1]}")
        return self.encode_img(_nchw(image))

    def cate_logits(self, features: torch.Tensor):
        if self.cate_classify is None:
            return None
        return self.cate_classify(features).reshape(-1, self.label_num)

    def d_phase(self, real, fake, cond):
        """D-update forwards: (real, wrong, fake logits, cate logits of the
        real features), in the order of `discriminators.py:181-199`."""
        real_feat = self(real)
        fake_feat = self(fake)
        real_logits = self.get_cond_logits(real_feat, cond)
        if real.shape[0] > 1:
            wrong_logits = self.get_cond_logits(real_feat[:-1], cond[1:])
        else:
            # one sample has no mismatched pair; a train-mode BN over an empty
            # batch would write NaN into the head's running statistics
            wrong_logits = real_logits.new_zeros((0,))
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return real_logits, wrong_logits, fake_logits, self.cate_logits(real_feat)

    def g_phase(self, fake, cond):
        """G-update forwards: (fake logits, cate logits of the fake features)."""
        fake_feat = self(fake)
        return self.get_cond_logits(fake_feat, cond), self.cate_logits(fake_feat)


class SegDiscriminator(ImageDiscriminator):
    """STAGE1_D_SEG: the same on 1-channel masks."""

    def __init__(self, ndf: int = 124, nef: int = 124, text_dim: int = 356,
                 label_num: int = 9, use_categories: bool = True, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(ndf, nef, text_dim, label_num, use_categories, in_channels, dtype)


class StoryDiscriminator(nn.Module):
    """STAGE1_D_STY_V2: per-frame encoder (all four convs spectral-normed),
    features averaged over the frames, a conditional head, no character head."""

    def __init__(self, ndf: int = 124, nef: int = 124, text_dim: int = 356,
                 label_num: int = 9, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encode_img = encoder64(3, ndf, sn_first=True, dtype=dtype)
        self.get_cond_logits = DGetLogits(ndf, nef + text_dim + label_num, dtype)

    def forward(self, story: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> frame-mean features (B, ndf*8, 4, 4)."""
        B, T = story.shape[:2]
        emb = self.encode_img(_nchw(story.reshape(B * T, *story.shape[2:])))
        return emb.view(B, T, *emb.shape[1:]).mean(dim=1)

    def d_phase(self, real, fake, cond):
        """(real, wrong, fake logits, None), order of `discriminators.py:279-296`."""
        real_feat = self(real)
        fake_feat = self(fake)
        real_logits = self.get_cond_logits(real_feat, cond)
        if real.shape[0] > 1:
            wrong_logits = self.get_cond_logits(real_feat[:-1], cond[1:])
        else:  # see ImageDiscriminator.d_phase
            wrong_logits = real_logits.new_zeros((0,))
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return real_logits, wrong_logits, fake_logits, None

    def g_phase(self, fake, cond):
        """(fake logits, None): no character head on the story D."""
        return self.get_cond_logits(self(fake), cond), None
