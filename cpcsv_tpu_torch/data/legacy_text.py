"""Legacy StackGAN text-to-image dataset (counterpart of
`cpcsv_tpu/data/legacy_text.py`; reference miscc/datasets.py:57-190).

The reference ships ``TextDataset`` — the birds/flowers loader inherited
from StackGAN (char-CNN-RNN embedding pickles, CUB bounding-box crops) —
and imports it from both entry points (main_pororo.py:23,
main_clevr.py:23) without ever constructing it.  The shipped class is
additionally unusable as-is: ``get_img`` prints ``img.shape`` on a PIL
Image (AttributeError on every call, miscc/datasets.py:80), ``load_bbox``
uses Python-2 ``xrange`` (:112), and ``load_captions`` calls ``.decode``
on ``str`` (:133).  This module is the working modern equivalent so a
reference user migrating a StackGAN-style corpus finds the same surface;
the three crashes above are bugs NOT replicated (see README.md). The port
keeps the JAX package's surface, items and deviations, so that its module
list is complete; nothing in the port constructs it either.

Deviations (documented, all unreachable or broken in the reference):
* images come back as uint8 HWC numpy arrays (not PIL) when ``transform``
  is None — every consumer in this repo is numpy-first;
* pickles are read with ``encoding="latin1"`` so the Python-2 pickles the
  StackGAN corpora ship actually load under Python 3;
* the random embedding pick draws from a seeded per-dataset stream
  (the port's data/pororo.py ``_SeededDraws``) instead of the global
  ``random`` module, matching this repo's determinism contract.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from PIL import Image

from cpcsv_tpu_torch.data.pororo import _SeededDraws
from cpcsv_tpu_torch.data.transforms import resize_image

_EMBEDDING_FILES = {
    # reference miscc/datasets.py:139-146
    "cnn-rnn": "char-CNN-RNN-embeddings.pickle",
    "cnn-gru": "char-CNN-GRU-embeddings.pickle",
    "skip-thought": "skip-thought-embeddings.pickle",
}


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


class TextDataset:
    """Map-style (image, text-embedding) dataset over a StackGAN corpus.

    Layout (reference miscc/datasets.py:58-76):
      data_dir/{split}/filenames.pickle          list of image keys
      data_dir/{split}/<embedding pickle>        (N, n_captions, D) array
      data_dir/{split}/class_info.pickle         optional per-image class id
      data_dir/images/<key>.jpg                  (flowers/coco layout)
      data_dir/CUB_200_2011/{images.txt,bounding_boxes.txt,images/...}
                                                 (birds layout, bbox crops)
    """

    def __init__(
        self,
        data_dir: str,
        split: str = "train",
        embedding_type: str = "cnn-rnn",
        imsize: int = 64,
        transform=None,
        target_transform=None,
        seed: int = 0,
    ):
        if embedding_type not in _EMBEDDING_FILES:
            raise ValueError(
                f"unknown embedding_type {embedding_type!r}; "
                f"expected one of {sorted(_EMBEDDING_FILES)}"
            )
        self.transform = transform
        self.target_transform = target_transform
        self.imsize = imsize
        self.data_dir = data_dir
        # "birds" anywhere in the path selects the CUB layout
        # (reference miscc/datasets.py:66-69).
        self.bbox = self._load_bbox() if "birds" in data_dir else None
        split_dir = os.path.join(data_dir, split)
        self.filenames = self._load_filenames(split_dir)
        self.embeddings = self._load_embedding(split_dir, embedding_type)
        if len(self.embeddings) != len(self.filenames):
            raise ValueError(
                f"{len(self.filenames)} filenames but "
                f"{len(self.embeddings)} embedding rows in {split_dir}"
            )
        self.class_id = self._load_class_id(split_dir, len(self.filenames))
        self._draws = _SeededDraws(seed)

    # -- artifact loaders ---------------------------------------------------

    def _load_bbox(self) -> dict:
        """key (path sans extension) -> [x, y, w, h] ints
        (reference miscc/datasets.py:97-120, sans pandas/xrange)."""
        cub = os.path.join(self.data_dir, "CUB_200_2011")
        with open(os.path.join(cub, "images.txt")) as f:
            filenames = [line.split()[1] for line in f if line.strip()]
        with open(os.path.join(cub, "bounding_boxes.txt")) as f:
            boxes = [
                [int(float(v)) for v in line.split()[1:5]]
                for line in f
                if line.strip()
            ]
        if len(boxes) != len(filenames):
            raise ValueError(
                f"CUB metadata mismatch: {len(filenames)} images.txt rows "
                f"vs {len(boxes)} bounding_boxes.txt rows"
            )
        return {
            name[: name.rfind(".")]: bbox
            for name, bbox in zip(filenames, boxes)
        }

    @staticmethod
    def _load_filenames(split_dir: str) -> list:
        return list(_load_pickle(os.path.join(split_dir, "filenames.pickle")))

    @staticmethod
    def _load_embedding(split_dir: str, embedding_type: str) -> np.ndarray:
        path = os.path.join(split_dir, _EMBEDDING_FILES[embedding_type])
        arr = np.asarray(_load_pickle(path))
        if arr.ndim != 3:
            raise ValueError(
                f"embeddings must be (N, n_captions, D); got {arr.shape}"
            )
        return arr

    @staticmethod
    def _load_class_id(split_dir: str, total_num: int) -> np.ndarray:
        """class_info.pickle when present, else arange
        (reference miscc/datasets.py:148-154)."""
        path = os.path.join(split_dir, "class_info.pickle")
        if os.path.isfile(path):
            return np.asarray(_load_pickle(path))
        return np.arange(total_num)

    # -- image path ----------------------------------------------------------

    def get_img(self, img_path: str, bbox):
        """Open, optionally bbox-crop (75%-of-longer-side square around the
        box center, clipped to the frame), resize to imsize*76//64 bilinear
        (reference miscc/datasets.py:78-95 minus the img.shape crash)."""
        img = Image.open(img_path).convert("RGB")
        width, height = img.size
        if bbox is not None:
            r = int(np.maximum(bbox[2], bbox[3]) * 0.75)
            center_x = int((2 * bbox[0] + bbox[2]) / 2)
            center_y = int((2 * bbox[1] + bbox[3]) / 2)
            y1 = int(np.maximum(0, center_y - r))
            y2 = int(np.minimum(height, center_y + r))
            x1 = int(np.maximum(0, center_x - r))
            x2 = int(np.minimum(width, center_x + r))
            img = img.crop([x1, y1, x2, y2])
        load_size = int(self.imsize * 76 / 64)
        arr = resize_image(np.asarray(img), load_size)
        if self.transform is not None:
            return self.transform(arr)
        return arr

    # -- dataset protocol ------------------------------------------------

    def set_epoch(self, epoch: int) -> None:
        self._draws.reseed(epoch)

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, index: int):
        key = self.filenames[index]
        if self.bbox is not None:
            bbox = self.bbox[key]
            img_dir = os.path.join(self.data_dir, "CUB_200_2011")
        else:
            bbox = None
            img_dir = self.data_dir
        img = self.get_img(os.path.join(img_dir, "images", f"{key}.jpg"), bbox)
        rows = self.embeddings[index]
        embedding = rows[self._draws.child().integers(0, rows.shape[0])]
        if self.target_transform is not None:
            embedding = self.target_transform(embedding)
        return img, embedding
