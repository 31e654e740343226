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
from cpcsv_tpu_torch.parallel.mesh import parse_mesh_shape

# MESH_SHAPE is honoured by data parallelism (`parallel/`): training takes
# any mesh with a `data` axis that spans the process group, sharding the
# batches over `data` and replicating over the other axes
# (`mesh.check_training_mesh`, which the trainer and the steps call), while
# serving and the walks split each generation call over the `data` axis of
# an eval mesh of the process's cards (`mesh.make_eval_mesh`, which falls
# back to the local cards for a larger mesh, as the JAX package's does).
# The JAX package's TPU lowering choices, accepted at every value its config
# accepts, each with one meaning in the port:
#   SCAN_STEPS (K > 1: K D+G pairs a dispatch, lax.scan; else one): K > 1
#     trains in chunks of K pairs with one readback a chunk
#     (`train/steps.py:make_scan_steps`), replayed as a CUDA graph of the
#     pair on a card, eagerly on the CPU and under gloo; else one pair at
#     a time;
#   USE_PALLAS (the Pallas DFN on a TPU): on a CUDA device the DFN always
#     runs its CUDA kernel, on the CPU its plain version; unlike the JAX
#     package's, it does not narrow the eval mesh to one device;
#   BN_BACKEND ("xla": flax BatchNorm; "mxu": its statistics as matmuls;
#     "pallas": as Pallas kernels): the port's train BN is the Pallas arm's
#     arithmetic on the BN kernels (`ops/batchnorm.py`) under every value.
BN_BACKENDS = ("xla", "mxu", "pallas")


def check_lowering_keys(cfg: Config) -> None:
    """ValueError where the JAX package would refuse a BN_BACKEND
    (ADAM_MU_DTYPE: `train.state.make_adam`) or a malformed MESH_SHAPE."""
    parse_mesh_shape(cfg.MESH_SHAPE)
    if cfg.BN_BACKEND not in BN_BACKENDS:
        raise ValueError(f"BN_BACKEND must be 'xla', 'mxu' or 'pallas', got {cfg.BN_BACKEND!r}")


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
    compute in cfg.COMPUTE_DTYPE, its up and down blocks recomputed in the
    backward under cfg.REMAT. On a CUDA device its DFN always runs the CUDA
    kernel."""
    check_lowering_keys(cfg)
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
        remat=cfg.REMAT,
        dtype=compute_dtype(cfg),
    )


def build_models(cfg: Config):
    """(G, D_im, D_st, D_se) for training, on the CPU, their parameters
    float32, their compute in cfg.COMPUTE_DTYPE; D_se is None without
    SEGMENT_LEARNING, and D_st holds the order-consistency VideoEncoder with
    USE_SEQ_CONSISTENCY (`cpcsv_tpu/models/factory.py:43-75`)."""
    net_g = generator_from_config(cfg)
    kw = dict(ndf=cfg.GAN.DF_DIM, nef=cfg.GAN.CONDITION_DIM, text_dim=cfg.TEXT.DIMENSION,
              label_num=cfg.LABEL_NUM, dtype=compute_dtype(cfg))
    d_se = SegDiscriminator(**kw) if cfg.SEGMENT_LEARNING else None
    return (net_g, ImageDiscriminator(**kw),
            StoryDiscriminator(use_seq_consistency=cfg.USE_SEQ_CONSISTENCY, **kw), d_se)
