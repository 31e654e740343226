"""Generator construction from a Config (counterpart of the generator part of
`cpcsv_tpu/models/factory.py`; reference `trainer.py:82-97`)."""

from __future__ import annotations

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.models.generator import StoryGenerator

# Keys of the JAX package that the port parses but does not honour: its TPU
# lowering (mesh, Pallas opt-in, remat, scan, BN backend) and its training.
# Each must keep its default; another value raises rather than being ignored.
UNSUPPORTED_KEYS = (
    "MESH_SHAPE", "USE_PALLAS", "REMAT", "SCAN_STEPS", "BN_BACKEND",
    "ADAM_MU_DTYPE", "USE_INFONCE", "INFONCE_TEMPERATURE",
)


def generator_from_config(cfg: Config) -> StoryGenerator:
    """The StoryGenerator of `cfg`, on the CPU, in float32. On a CUDA device
    its DFN always runs the CUDA kernel."""
    if cfg.COMPUTE_DTYPE != "float32":
        raise NotImplementedError(
            f"COMPUTE_DTYPE={cfg.COMPUTE_DTYPE!r}: the port's generator runs float32 only"
        )
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
    )
