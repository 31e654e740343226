"""FVD, the Frechet Video Distance (counterpart of `cpcsv_tpu/evaluation/fvd.py`;
reference `fvd/fvd.py`, `fvd/frechet_video_distance.py`, `fvd/loader.py`).

`calculate_fvd(gen_dir, ref_dir)` reads the numbered-PNG dumps that
`Infer.inference_samples` writes ({1..N}.png, grouped into clips of
`frames_per_video`), embeds both sides and returns the Frechet distance.
The embedder is the Kinetics-400 I3D (`i3d.make_i3d_embedder`) when its
weights resolve; otherwise it is the R(2+1)D-18 FSD backbone, and the score
is "FVD-R": consistent within itself, not comparable to published I3D FVD.
The reference's invariant holds: the clip count must be divisible by 16
(fvd/fvd.py:55).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from PIL import Image

from cpcsv_tpu_torch.data.transforms import normalize_image
from cpcsv_tpu_torch.evaluation.datasets import FolderStoryDataset
from cpcsv_tpu_torch.evaluation.features import extract_activations
from cpcsv_tpu_torch.evaluation.frechet import (
    calculate_activation_statistics,
    calculate_frechet_distance,
)
from cpcsv_tpu_torch.evaluation.weights import resolve_weights


class VideoGenerateDataset:
    """A folder's numbered PNGs as clips of `min_len` frames, in number
    order; the tail that fills no clip is left out (reference
    fvd/loader.py:125-160). Items (T, H, W, 3) float32 in [-1, 1]."""

    def __init__(self, folder: str, min_len: int = 10, imsize: int = 64):
        self.folder, self.min_len, self.imsize = folder, min_len, imsize
        files = sorted((f for f in os.listdir(folder) if f.endswith(".png")),
                       key=lambda f: int(f.split(".")[0]))
        self.clips = [files[i * min_len:(i + 1) * min_len] for i in range(len(files) // min_len)]

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, item):
        return np.stack([
            normalize_image(np.array(Image.open(os.path.join(self.folder, f)).convert("RGB")),
                            self.imsize)
            for f in self.clips[item]])


class VideoFolderDataset:
    """Story-folder clips with `degree` random frame-pair swaps each (the
    reference's FVD-against-shuffling study, fvd/loader.py:43-122), drawn
    from a numpy generator seeded `seed`."""

    def __init__(self, folder: str, video_len: int = 5, imsize: int = 64, degree: int = 0,
                 seed: int = 0):
        self.inner = FolderStoryDataset(folder, video_len, imsize)
        self.degree = degree
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.inner)

    def __getitem__(self, item):
        story = self.inner[item]
        for _ in range(self.degree):
            i, j = self.rng.integers(0, story.shape[0], 2)
            story[[i, j]] = story[[j, i]]
        return story


def default_embedder(i3d_weights: str | None = None, device: str | torch.device = "cuda"):
    """The I3D embedder when Kinetics-400 I3D weights resolve (`i3d_weights`,
    $CPCSV_METRIC_WEIGHTS_DIR or ~/.cache/cpcsv_tpu/weights): only then does
    the reference's ~131 empty-frame anchor apply (fvd/fvd.py:16-18).
    Otherwise the R(2+1)D backbone ("FVD-R"), whose factory warns when it
    runs from random init."""
    path = resolve_weights("i3d_kinetics400", i3d_weights)
    if path:
        from cpcsv_tpu_torch.evaluation.i3d import make_i3d_embedder

        return make_i3d_embedder(path, device)
    from cpcsv_tpu_torch.evaluation.r2plus1d import make_fsd_extractor

    return make_fsd_extractor(None, device)


class _Head:
    """The first n items of a dataset."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def calculate_fvd(gen_path: str, ref_path: str = "./Evaluation/ref", num_of_video: int = 272,
                  frames_per_video: int = 10, batch_size: int = 16, embedder=None) -> float:
    """FVD of the numbered PNGs under `gen_path` against those under
    `ref_path` (reference fvd/fvd.py:47-88): up to `num_of_video` clips a
    side, as many on both, rounded down to whole batches with a warning."""
    assert num_of_video % 16 == 0, "video number must be divisible by 16"
    embedder = embedder or default_embedder()
    gen = VideoGenerateDataset(gen_path, frames_per_video)
    ref = VideoGenerateDataset(ref_path, frames_per_video)
    n = min(num_of_video, len(gen), len(ref))
    if n < batch_size:
        raise ValueError(
            f"FVD needs at least {batch_size} clips per side; got gen={len(gen)} "
            f"ref={len(ref)} under {gen_path!r}/{ref_path!r}")
    if n % batch_size:
        rounded = n // batch_size * batch_size
        warnings.warn(
            f"FVD clip count {n} not divisible by {batch_size}: using the first {rounded} "
            "clips per side (reference invariant fvd/fvd.py:55)", stacklevel=2)
        n = rounded
    m1, s1 = calculate_activation_statistics(
        extract_activations(_Head(gen, n), embedder, batch_size))
    m2, s2 = calculate_activation_statistics(
        extract_activations(_Head(ref, n), embedder, batch_size))
    return calculate_frechet_distance(m1, s1, m2, s2)
