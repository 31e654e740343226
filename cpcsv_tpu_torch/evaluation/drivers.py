"""Serving driver (counterpart of the sampling part of
`cpcsv_tpu/evaluation/drivers.py`; reference `inference.py:32-199`).

`Infer` holds an eval-mode generator on one device and turns story batches
into frames: `sample_videos_np` returns numpy videos (B, T, 64, 64, 3) in
[-1, 1], and `generate_story` writes the reference's folder trees
Evaluation/{name}/{original,generate}/{story}/{t}.png.
"""

from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from cpcsv_tpu_torch.config import Config
from cpcsv_tpu_torch.device import float32_math, resolve_device
from cpcsv_tpu_torch.models.factory import generator_from_config
from cpcsv_tpu_torch.utils.image import save_png


def _batch_motion_content(cfg: Config, batch):
    """(motion (B, T, 365), content (B, T, 356)) host arrays of a story batch:
    motion is the description followed by the labels."""
    desc = np.asarray(batch["description"], np.float32)[:, :, : cfg.TEXT.DIMENSION]
    labels = np.asarray(batch["labels"], np.float32)
    return np.concatenate([desc, labels], axis=2), desc


class Infer:
    """Eval-mode story generation on one device.

    `state_dict` is the generator's, in the reference torch layout (a
    `netG_epoch_E.pth`, or JAX variables converted by
    `utils.weights.generator_state_dict_from_jax`); it is loaded strictly.
    Noise comes from a `torch.Generator` on the device, seeded with `seed`.
    """

    def __init__(
        self,
        cfg: Config,
        state_dict: dict[str, torch.Tensor],
        device: str | torch.device = "cuda",
        output_dir: str = "output",
        seed: int = 0,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.eval_dir = os.path.join(output_dir, "Evaluation", cfg.CONFIG_NAME or "eval")
        self.net_g = generator_from_config(cfg)
        self.net_g.load_state_dict(state_dict, strict=True)
        self.net_g.to(self.device).eval().requires_grad_(False)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    @torch.no_grad()
    def sample_videos_np(self, batch, seg: bool = False):
        """Story batch -> (video (B, T, 64, 64, 3), mask (B*T, 64, 64, 1) or
        None), numpy float32, computed in float32 whatever the global TF32
        flags say."""
        motion, content = _batch_motion_content(self.cfg, batch)
        with float32_math():
            out = self.net_g.sample_videos(
                torch.from_numpy(motion).to(self.device),
                torch.from_numpy(content).to(self.device),
                seg=seg,
                generator=self.generator,
            )
        mask = out.seg.cpu().numpy() if out.seg is not None else None
        return out.image.cpu().numpy(), mask

    def generate_story(self, storyloader, dirname: str = ""):
        """original/ and generate/ folder trees (reference inference.py:147-199).
        Both trees are cleared first, so a smaller walk leaves no stale stories."""
        orig_dir = os.path.join(self.eval_dir, dirname, "original")
        gen_dir = os.path.join(self.eval_dir, dirname, "generate")
        for d in (orig_dir, gen_dir):
            if os.path.isdir(d):
                shutil.rmtree(d)
        story_id = 0
        for batch in storyloader:
            fake, _ = self.sample_videos_np(batch)
            real = np.asarray(batch["images"], np.float32)
            for b in range(fake.shape[0]):
                for root, frames in ((gen_dir, fake), (orig_dir, real)):
                    d = os.path.join(root, str(story_id))
                    os.makedirs(d, exist_ok=True)
                    for t in range(fake.shape[1]):
                        save_png(frames[b, t], os.path.join(d, f"{t}.png"))
                story_id += 1
        return orig_dir, gen_dir
