"""The evaluation's datasets (counterpart of `cpcsv_tpu/evaluation/datasets.py`).

Folder readers (reference `miscc/datasets.py:19-55`) read the stories a
walk wrote back for the metrics; the generator wrappers (reference
`fid/utils.py:12-87`, `utils.py:14-49`) sample the model as they are read.
Items are numpy HWC float32 in [-1, 1], as the training datasets'.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from cpcsv_tpu_torch.data.transforms import normalize_image
from cpcsv_tpu_torch.evaluation import sampling


class FolderStoryDataset:
    """Story directories, each holding {0..T-1}.png (reference
    FolderStoryDataset)."""

    def __init__(self, img_folder: str, video_len: int = 5, imsize: int = 64):
        self.img_folder = img_folder
        self.stories = sorted(os.listdir(img_folder))
        self.video_len = video_len
        self.imsize = imsize

    def __len__(self):
        return len(self.stories)

    def __getitem__(self, item):
        d = os.path.join(self.img_folder, self.stories[item])
        frames = []
        for t in range(self.video_len):
            im = Image.open(os.path.join(d, f"{t}.png")).convert("RGB")
            frames.append(normalize_image(np.array(im), self.imsize))
        return np.stack(frames, axis=0)  # (T, H, W, C)


class FolderImageDataset:
    """Every PNG under a folder, the story layout flattened (reference
    FolderImageDataset)."""

    def __init__(self, img_folder: str, imsize: int = 64):
        self.imsize = imsize
        self.files = []
        for root, _, files in os.walk(img_folder):
            for f in sorted(files):
                if f.endswith(".png"):
                    self.files.append(os.path.join(root, f))
        self.files.sort()

    def __len__(self):
        return len(self.files)

    def __getitem__(self, item):
        im = Image.open(self.files[item]).convert("RGB")
        return normalize_image(np.array(im), self.imsize)


class IgnoreLabelDataset:
    """A dict dataset's 'images' alone (reference utils.py:12-20)."""

    def __init__(self, orig, key: str = "images"):
        self.orig = orig
        self.key = key

    def __len__(self):
        return len(self.orig)

    def __getitem__(self, index):
        return np.asarray(self.orig[index][self.key])


class StoryGANDataset:
    """The generator's story for each item of a story dataset (reference
    fid/utils.py:52-87), generated `chunk` stories at a time on the
    generator's device through the sampler (`sampling.sample`; a ragged last
    chunk is one more key): `net_g` in eval mode, its noise from `generator`
    (a torch.Generator on that device), float32 with TF32 off. Given an eval
    `mesh` (`mesh.make_eval_mesh`), each chunk is split over it where
    `mesh.eval_shards` allows,
    as the JAX package's (`cpcsv_tpu/evaluation/datasets.py:134-150`): full
    chunks shard, a ragged tail that the data axis does not divide runs on
    the generator's device."""

    keep_real = False  # StoryGANSSIMDataset keeps the real stories it read

    def __init__(self, net_g, testdataset, generator: torch.Generator, text_dim: int = 356,
                 chunk: int = 64, mesh: Optional[Sequence[torch.device]] = None):
        self.net_g = net_g
        self.ds = testdataset
        self.generator = generator
        self.text_dim = text_dim
        self.chunk = chunk
        self.mesh = mesh
        self.device = next(net_g.parameters()).device
        self._cache: dict[int, np.ndarray] = {}
        self._real_cache: dict[int, np.ndarray] = {}

    def __len__(self):
        return len(self.ds)

    def _generate_chunk(self, start: int):
        idxs = range(start, min(start + self.chunk, len(self.ds)))
        motions, contents = [], []
        for i in idxs:
            item = self.ds[i]
            desc = np.asarray(item["description"], np.float32)[:, : self.text_dim]
            motions.append(np.concatenate([desc, np.asarray(item["labels"], np.float32)], axis=1))
            contents.append(desc)
            if self.keep_real:
                self._real_cache[i] = np.asarray(item["images"], np.float32)
        fake, _ = sampling.sample(self.net_g, torch.from_numpy(np.stack(motions)).to(self.device),
                                  torch.from_numpy(np.stack(contents)).to(self.device),
                                  generator=self.generator, mesh=self.mesh)
        fake = fake.float().cpu().numpy()
        for j, i in enumerate(idxs):
            self._cache[i] = fake[j]

    def __getitem__(self, index):
        if index not in self._cache:
            self._generate_chunk((index // self.chunk) * self.chunk)
        return self._cache[index]


class StoryGANSSIMDataset(StoryGANDataset):
    """(fake, real) story pairs for SSIM (reference utils.py
    StoryGANSSIMDataset). The real story is the item the generation read,
    kept as it was: reading ds[index] again would redraw its crops and
    descriptions."""

    keep_real = True

    def __getitem__(self, index):
        fake = super().__getitem__(index)
        return fake, self._real_cache[index]
