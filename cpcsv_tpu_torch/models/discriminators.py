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
`d_phase`, `d_phase_infonce` and `g_phase` call the encoder, the head and
the story D's order-consistency VideoEncoder (`seq_consisten_model`, with
`use_seq_consistency`) in the JAX order, which sets how the BN running
statistics and the SN vectors evolve.

InfoNCE (cfg.USE_INFONCE): `pairwise_cond_logits` scores every (feature_i,
condition_j) pair in one head call over B² rows, i-major
(`discriminators.py:29-37`); `d_phase_infonce` calls it in place of the real
and the wrong head calls, so the head's statistics come from (pairs, fake).

`dtype` is the compute dtype (cfg.COMPUTE_DTYPE; None = float32): every conv
runs in it, with float32 parameters, so the features and logits come out in
it; the losses take the logits to float32.

In a process group (`parallel/`) each rank holds its data shard of the
global batch, and the pairs that cross shards are built from the global
index (the gathers run over the rank's data group, `mesh.gather_rows`), as
the JAX package's one program pairs the global batch: the wrong pairs
(feature i, condition i + 1) take their conditions from the gathered global
conditions (the D step's carry no gradient; the features are never
gathered), so a shard's last feature meets the next shard's first condition
and the last shard has one wrong pair fewer; whether there is a wrong pair
at all is asked of the global batch; and InfoNCE's pair block is the rank's
features against every global condition, (B/D, B) for D shards, the head's
BN over the B² global rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from cpcsv_tpu_torch.models.video_encoder import VideoEncoder
from cpcsv_tpu_torch.ops.blocks import BatchNorm2d, Conv2d, Conv4x4s2
from cpcsv_tpu_torch.ops.spectral_norm import SNConv2d
from cpcsv_tpu_torch.parallel.distributed import is_distributed
from cpcsv_tpu_torch.parallel.mesh import batch_rows, gather_rows, wrong_pair_rows

LEAK = 0.2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def pairwise_cond_logits(head: "DGetLogits", features: torch.Tensor,
                         conditions: torch.Tensor) -> torch.Tensor:
    """(B, B) logits of head(features_i, conditions_j): one call over B² rows,
    features repeated i-major and conditions tiled; in a process group the
    rank's (b, B) block, its b features against the B global conditions."""
    conditions = gather_rows(conditions)
    b, B = features.shape[0], conditions.shape[0]
    logits = head(features.repeat_interleave(B, dim=0), conditions.repeat(b, 1))
    return logits.view(b, B)


def wrong_pair_logits(head: "DGetLogits", real_feat: torch.Tensor,
                      cond: torch.Tensor) -> torch.Tensor:
    """head(real_feat[i], cond[i + 1]) over the global batch's i < B − 1, this
    rank's of them; empty logits where the global batch has one row: one
    sample has no mismatched pair, and a train-mode BN over an empty batch
    would write NaN into the head's running statistics."""
    if not is_distributed():
        if real_feat.shape[0] > 1:
            return head(real_feat[:-1], cond[1:])
        return real_feat.new_zeros((0,))
    rows = batch_rows(real_feat.shape[0])
    if rows.total == 1:
        return real_feat.new_zeros((0,))
    wrong = wrong_pair_rows(rows)
    conds = gather_rows(cond)[wrong.lo + 1:wrong.lo + 1 + wrong.local]
    return head(real_feat[:wrong.local], conds)


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
        wrong_logits = wrong_pair_logits(self.get_cond_logits, real_feat, cond)
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return real_logits, wrong_logits, fake_logits, self.cate_logits(real_feat)

    def g_phase(self, fake, cond):
        """G-update forwards: (fake logits, cate logits of the fake features)."""
        fake_feat = self(fake)
        return self.get_cond_logits(fake_feat, cond), self.cate_logits(fake_feat)

    def d_phase_infonce(self, real, fake, cond):
        """InfoNCE D-update forwards: (pair logits (B, B), or the rank's
        (B/W, B) block in a process group, fake logits, cate
        logits of the real features), order of `discriminators.py:212-222`."""
        real_feat = self(real)
        fake_feat = self(fake)
        pair = pairwise_cond_logits(self.get_cond_logits, real_feat, cond)
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return pair, fake_logits, self.cate_logits(real_feat)


class SegDiscriminator(ImageDiscriminator):
    """STAGE1_D_SEG: the same on 1-channel masks."""

    def __init__(self, ndf: int = 124, nef: int = 124, text_dim: int = 356,
                 label_num: int = 9, use_categories: bool = True, in_channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(ndf, nef, text_dim, label_num, use_categories, in_channels, dtype)


class StoryDiscriminator(nn.Module):
    """STAGE1_D_STY_V2: per-frame encoder (all four convs spectral-normed),
    features averaged over the frames, a conditional head, no character head;
    with `use_seq_consistency`, the order-consistency VideoEncoder."""

    def __init__(self, ndf: int = 124, nef: int = 124, text_dim: int = 356,
                 label_num: int = 9, use_seq_consistency: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.encode_img = encoder64(3, ndf, sn_first=True, dtype=dtype)
        self.get_cond_logits = DGetLogits(ndf, nef + text_dim + label_num, dtype)
        self.seq_consisten_model = VideoEncoder(dtype) if use_seq_consistency else None

    def forward(self, story: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) -> frame-mean features (B, ndf*8, 4, 4)."""
        B, T = story.shape[:2]
        emb = self.encode_img(_nchw(story.reshape(B * T, *story.shape[2:])))
        return emb.view(B, T, *emb.shape[1:]).mean(dim=1)

    def order_logits(self, shuffled):
        """The VideoEncoder's order logits (B, 1) of the shuffle-augmented
        stories, or None without the branch or without `shuffled`."""
        if self.seq_consisten_model is None or shuffled is None:
            return None
        return self.seq_consisten_model(shuffled)

    def d_phase(self, real, fake, cond, shuffled=None):
        """(real, wrong, fake logits, order logits of `shuffled` or None),
        order of `discriminators.py:279-296`."""
        real_feat = self(real)
        fake_feat = self(fake)
        real_logits = self.get_cond_logits(real_feat, cond)
        wrong_logits = wrong_pair_logits(self.get_cond_logits, real_feat, cond)
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return real_logits, wrong_logits, fake_logits, self.order_logits(shuffled)

    def d_phase_infonce(self, real, fake, cond, shuffled=None):
        """(pair logits (B, B), fake logits, order logits or None)."""
        real_feat = self(real)
        fake_feat = self(fake)
        pair = pairwise_cond_logits(self.get_cond_logits, real_feat, cond)
        fake_logits = self.get_cond_logits(fake_feat, cond)
        return pair, fake_logits, self.order_logits(shuffled)

    def g_phase(self, fake, cond, real=None):
        """(fake logits, VideoEncoder(fake), VideoEncoder(real)); the last two
        None without the branch or without `real`. The encoder runs on `real`
        first, in train mode, as JAX's does (`discriminators.py:298-305`), so
        `fake` meets the BN statistics and SN vectors `real` left; `real`'s
        output takes no gradient, as the loss stops it anyway."""
        fake_logits = self.get_cond_logits(self(fake), cond)
        if self.seq_consisten_model is None or real is None:
            return fake_logits, None, None
        with torch.no_grad():
            cons_real = self.seq_consisten_model(real)
        return fake_logits, self.seq_consisten_model(fake), cons_real
