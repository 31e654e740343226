"""Scalar and image logging under the reference's tensorboard tag names
(counterpart of `cpcsv_tpu/utils/logging.py`; reference
trainer.py:336-360,417-444): an always-on `metrics.jsonl` stream (one
{"tag", "value", "step", "ts"} record a line), PNGs of the image tags, and
tensorboardX beside them when it can be imported."""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except Exception:
            self._tb = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(np.asarray(value))
        self._jsonl.write(
            json.dumps({"tag": tag, "value": value, "step": int(step), "ts": time.time()}) + "\n")
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, scalars: dict, step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_image(self, tag: str, image_hwc: np.ndarray, step: int) -> None:
        """image_hwc: uint8 HWC, written to {tag}_{step:05d}.png. A 1-channel
        grid (the segment masks) is written as a grey PNG; the JAX package's
        PIL call refuses that shape and writes none."""
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step:05d}.png")
        try:
            from PIL import Image

            Image.fromarray(image_hwc.squeeze(-1) if image_hwc.shape[-1] == 1 else image_hwc
                            ).save(path)
        except Exception:
            pass
        if self._tb:
            self._tb.add_image(tag, image_hwc.transpose(2, 0, 1) / 255.0, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb:
            self._tb.flush()
