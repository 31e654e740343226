"""Model construction from a Config (counterpart of
`cpcsv_tpu/models/factory.py`; reference `trainer.py:82-97`)."""

from __future__ import annotations

from typing import Optional

import torch

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.models.discriminators import (
    ImageDiscriminator,
    SegDiscriminator,
    StoryDiscriminator,
)
from cpcsv_tpu_torch.models.generator import StoryGenerator

# Keys of the JAX package that the port parses but does not honour: its TPU
# lowering (mesh, Pallas opt-in, remat, scan, BN backend) and its training.
# Each must keep its default; another value raises rather than being ignored.
UNSUPPORTED_KEYS = (
    "MESH_SHAPE", "USE_PALLAS", "REMAT", "SCAN_STEPS", "BN_BACKEND",
    "ADAM_MU_DTYPE", "USE_INFONCE", "INFONCE_TEMPERATURE",
)


# cfg.COMPUTE_DTYPE -> the modules' compute dtype (None: no casts, the
# parameters' float32)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: Config) -> Optional[torch.dtype]:
    if cfg.COMPUTE_DTYPE not in COMPUTE_DTYPES:
        raise ValueError(f"COMPUTE_DTYPE={cfg.COMPUTE_DTYPE!r} invalid; one of "
                         f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[cfg.COMPUTE_DTYPE]


def generator_from_config(cfg: Config) -> StoryGenerator:
    """The StoryGenerator of `cfg`, on the CPU, its parameters float32, its
    compute in cfg.COMPUTE_DTYPE. On a CUDA device its DFN always runs the
    CUDA kernel."""
    default = Config()
    for key in UNSUPPORTED_KEYS:
        if getattr(cfg, key) != getattr(default, key):
            raise NotImplementedError(
                f"{key}={getattr(cfg, key)!r}: the port does not support this key; "
                f"leave it at its default {getattr(default, key)!r}"
            )
    return StoryGenerator(
        video_len=cfg.VIDEO_LEN,
        motion_dim=cfg.TEXT.DIMENSION + cfg.LABEL_NUM,
        content_dim=cfg.GAN.CONDITION_DIM,
        noise_dim=cfg.GAN.Z_DIM,
        gf_dim=cfg.GAN.GF_DIM * 8,
        gf_dim_seg=cfg.GAN.GF_SEG_DIM,
        text_dim=cfg.TEXT.DIMENSION,
        use_segment=cfg.SEGMENT_LEARNING,
        cascade=cfg.CASCADE_MODEL,
        torch_repeat_quirk=cfg.TORCH_REPEAT_QUIRK,
        fused_upsample=cfg.FUSED_UPSAMPLE,
        dtype=compute_dtype(cfg),
    )


# Training settings the port's train step does not cover yet, with the slice
# that brings each.
NOT_TRAINED_YET = {
    "USE_SEQ_CONSISTENCY": (True, "the VideoEncoder order-consistency branch comes with a "
                                  "later training slice"),
    "SEGMENT_LEARNING": (False, "the port trains the segment-learning generators "
                                "(final.yml, cascade.yml); the plain one comes with a later "
                                "slice"),
}


def build_models(cfg: Config):
    """(G, D_im, D_st, D_se) for training, on the CPU, their parameters
    float32, their compute in cfg.COMPUTE_DTYPE."""
    for key, (refused, why) in NOT_TRAINED_YET.items():
        if getattr(cfg, key) == refused:
            raise NotImplementedError(f"{key}={refused!r}: {why}")
    net_g = generator_from_config(cfg)
    kw = dict(ndf=cfg.GAN.DF_DIM, nef=cfg.GAN.CONDITION_DIM, text_dim=cfg.TEXT.DIMENSION,
              label_num=cfg.LABEL_NUM, dtype=compute_dtype(cfg))
    return net_g, ImageDiscriminator(**kw), StoryDiscriminator(**kw), SegDiscriminator(**kw)
