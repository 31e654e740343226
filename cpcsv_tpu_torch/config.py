"""Config system of the PyTorch port: the same YAML schema, key names,
defaults and merge rules as the JAX package's `cpcsv_tpu/config.py` (itself
the reference's `miscc/config.py:9-66`), parsed into a frozen dataclass.

Merge semantics (reference `miscc/config.py:68-99`):
  * unknown keys raise ``KeyError``
  * type mismatches raise ``ValueError`` (ints are accepted for floats)

The port keeps its own copy so that it imports nothing of `cpcsv_tpu`. Keys
it does not honour yet are parsed for schema parity and must keep their
defaults: `models.factory.generator_from_config` refuses other values.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

import yaml

CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


@dataclass(frozen=True)
class CoeffConfig:
    KL: float = 2.0


@dataclass(frozen=True)
class TrainConfig:
    FLAG: bool = True
    IM_BATCH_SIZE: int = 64
    ST_BATCH_SIZE: int = 64
    MAX_EPOCH: int = 600
    SNAPSHOT_INTERVAL: int = 50
    PRETRAINED_MODEL: str = ""
    PRETRAINED_EPOCH: int = 600
    LR_DECAY_EPOCH: int = 600
    DISCRIMINATOR_LR: float = 2e-4
    GENERATOR_LR: float = 2e-4
    SEGMENT_NAME: str = "img_segment"
    COEFF: CoeffConfig = field(default_factory=CoeffConfig)


@dataclass(frozen=True)
class GanConfig:
    CONDITION_DIM: int = 124
    Z_DIM: int = 100
    DF_DIM: int = 124
    GF_DIM: int = 256
    GF_SEG_DIM: int = 1024
    R_NUM: int = 4


@dataclass(frozen=True)
class TextConfig:
    DIMENSION: int = 356


@dataclass(frozen=True)
class Config:
    """Top-level config. Field names/defaults mirror reference `miscc/config.py`."""

    DATASET_NAME: str = "birds"
    EMBEDDING_TYPE: str = "cnn-rnn"
    CONFIG_NAME: str = ""
    GPU_ID: str = "0"
    CUDA: bool = True
    WORKERS: int = 6
    VIDEO_LEN: int = 5
    NET_G: str = ""
    NET_D: str = ""
    STAGE1_G: str = ""
    DATA_DIR: str = ""
    VIS_COUNT: int = 64

    USE_SEQ_CONSISTENCY: bool = False
    CONSISTENCY_RATIO: float = 1.0
    SEGMENT_LEARNING: bool = True
    SEGMENT_RATIO: float = 1.0
    IMAGE_RATIO: float = 5.0
    RECONSTRUCT_LOSS: float = 1.0
    EVALUATE_FID_SCORE: bool = False
    CASCADE_MODEL: bool = True
    Z_DIM: int = 100
    IMSIZE: int = 64
    SESIZE: int = 64
    STAGE: int = 1

    LABEL_NUM: int = 9
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    GAN: GanConfig = field(default_factory=GanConfig)
    TEXT: TextConfig = field(default_factory=TextConfig)

    # --- extensions of the JAX package (optional keys, same defaults) ---
    # "float32" | "bfloat16": the compute dtype of the convolutions, matmuls
    # and GRUs (models/factory.py); parameters, BN statistics, losses and Adam
    # stay float32
    COMPUTE_DTYPE: str = "float32"
    MESH_SHAPE: str = ""
    USE_PALLAS: bool = False
    REMAT: bool = False
    # nearest-2x upsample + conv3x3 lowering in the generator trunks:
    # "off" | "parity4" | "parity1" | "deconv" (ops/fused_upsample.py)
    FUSED_UPSAMPLE: str = "deconv"
    SCAN_STEPS: int = 20
    USE_INFONCE: bool = False
    INFONCE_TEMPERATURE: float = 1.0
    # Reproduce the reference's content tiling (model.py:361
    # `r_mu.repeat(video_len, 1)`): frame (b, t) gets the content code of
    # sample (b*T+t) % B. False = per-sample pairing.
    TORCH_REPEAT_QUIRK: bool = False
    BN_BACKEND: str = "xla"
    ADAM_MU_DTYPE: str = "float32"

    @property
    def motion_dim(self) -> int:
        return self.TEXT.DIMENSION + self.LABEL_NUM

    @property
    def content_dim(self) -> int:
        return self.GAN.CONDITION_DIM

    def with_updates(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)


def default_config() -> Config:
    return Config()


def _merge_into(data: Mapping[str, Any], obj: Any, path: str = "") -> Any:
    """Merge a mapping into a (nested) frozen dataclass, reference-style checks."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot merge into non-dataclass at {path!r}")
    names = {f.name for f in dataclasses.fields(obj)}
    updates: dict[str, Any] = {}
    for key, value in data.items():
        if key not in names:
            raise KeyError(f"{key} is not a valid config key")
        old = getattr(obj, key)
        if dataclasses.is_dataclass(old):
            if not isinstance(value, Mapping):
                raise ValueError(
                    f"Type mismatch ({type(old)} vs. {type(value)}) for config key: {key}"
                )
            updates[key] = _merge_into(value, old, f"{path}{key}.")
            continue
        if isinstance(old, bool):
            if not isinstance(value, bool):
                raise ValueError(
                    f"Type mismatch (bool vs. {type(value)}) for config key: {key}"
                )
        elif isinstance(old, float):
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                raise ValueError(
                    f"Type mismatch (float vs. {type(value)}) for config key: {key}"
                )
            value = float(value)
        elif isinstance(old, int):
            if not isinstance(value, int) or isinstance(value, bool):
                raise ValueError(
                    f"Type mismatch (int vs. {type(value)}) for config key: {key}"
                )
        elif isinstance(old, str):
            if value is None:
                value = ""
            if not isinstance(value, str):
                raise ValueError(
                    f"Type mismatch (str vs. {type(value)}) for config key: {key}"
                )
        updates[key] = value
    return dataclasses.replace(obj, **updates)


def config_from_file(filename: str, base: Config | None = None) -> Config:
    """Load a YAML config and merge it into the defaults (reference
    `cfg_from_file`, `miscc/config.py:102-108`). A bare name such as
    ``"final.yml"`` is looked up in the port's `configs/` directory."""
    if not os.path.exists(filename) and os.path.exists(os.path.join(CONFIG_DIR, filename)):
        filename = os.path.join(CONFIG_DIR, filename)
    with open(filename, "r") as f:
        raw = yaml.safe_load(f) or {}
    cfg = _merge_into(raw, base or default_config())
    # reference `main_pororo.py:67-68`: cascade implies segment learning
    if cfg.CASCADE_MODEL and not cfg.SEGMENT_LEARNING:
        cfg = cfg.with_updates(SEGMENT_LEARNING=True)
    return cfg
