"""CLEVR-for-StoryGAN datasets (counterpart of `cpcsv_tpu/data/clevr.py`;
reference `datasets/clevr.py`), items bit-equal to the JAX package's.

On disk: CLEVR_dict.npy, a pickled dict "<story>_<t>" -> the frame's 18-d
attribute code; frames CLEVR_new_%06d_%d.png and masks
CLEVR_new_%06d_%d_mask.png (read as L), t = 1..4. Train stories are ids
1-10000, test stories 10001-13000. A story's labels are the cumulative OR
of its codes up to each frame: `labels` the 8-d object part (dims 2:10) on
both the story and the image path, `super_labels` the reference story
path's 15-d [0:2] + [2:10] + [13:18]. The image dataset picks its frame
from `_SeededDraws(seed).child()`, so the loader's `set_epoch` reseeds it.

Two documented deviations of the JAX package, kept because it is the
reference the port is held to:
  * the reference's `__len__ = edn - srt + 1` (an off-by-one past the last
    story, reference :68,136) is not replicated: the ranges are exact;
  * the reference's story path emits the 15-d super_label while its image
    path emits the 8-d label, which cannot feed one motion_dim GRU (its
    clevr.yml was never shipped). Here `labels` is the 8-d label on both
    paths (LABEL_NUM 8 in configs/clevr.yml), the 15-d one under
    `super_labels`.
"""

from __future__ import annotations

from os.path import join

import numpy as np
from PIL import Image

from cpcsv_tpu_torch.data.pororo import _SeededDraws
from cpcsv_tpu_torch.data.transforms import normalize_image, video_transform

ID_RANGES = {"train": (1, 10001), "test": (10001, 13001)}  # [first, last + 1) story ids


def _load_dict(folder: str) -> dict:
    return np.load(join(folder, "CLEVR_dict.npy"), allow_pickle=True, encoding="latin1").item()


def _frame(folder: str, story_id: int, t: int, suffix: str = "") -> str:
    return join(folder, "CLEVR_new_%06d_%d%s.png" % (story_id, t, suffix))


class _ClevrSplit:
    def __init__(self, image_path: str, data_type: str, video_len: int, imsize: int):
        self.dir_path = image_path
        self.descriptions = _load_dict(image_path)
        self.video_len = video_len
        self.imsize = imsize
        self.srt, self.edn = ID_RANGES["train" if data_type == "train" else "test"]

    def __len__(self):
        return self.edn - self.srt

    def _code(self, story_id: int, t: int) -> np.ndarray:
        return np.asarray(self.descriptions["%d_%d" % (story_id, t)], dtype=np.float32)


class ClevrStoryDataset(_ClevrSplit):
    def __init__(self, image_path, data_type="train", video_len=4, imsize=64):
        super().__init__(image_path, data_type, video_len, imsize)

    def __getitem__(self, item):
        story_id = self.srt + item
        frames, des, labels, super_labels = [], [], [], []
        attr = None
        for t in range(1, self.video_len + 1):
            frames.append(np.array(Image.open(_frame(self.dir_path, story_id, t)).convert("RGB")))
            code = self._code(story_id, t)
            attr = code if attr is None else np.maximum(attr, code)  # cumulative OR
            des.append(code)
            labels.append(attr[2:10].astype(np.float32))
            super_labels.append(
                np.concatenate([attr[:2], attr[2:10], attr[13:18]]).astype(np.float32))
        return {
            "images": video_transform(np.stack(frames), self.imsize),
            "description": np.stack(des),
            "labels": np.stack(labels),
            "super_labels": np.stack(super_labels),
            "text": ["clevr %d frame %d" % (story_id, t) for t in range(1, self.video_len + 1)],
        }


class ClevrImageDataset(_ClevrSplit):
    def __init__(self, image_path, data_type="train", video_len=4, imsize=64, sesize=64,
                 use_segment=False, seed: int = 0):
        super().__init__(image_path, data_type, video_len, imsize)
        self._draws = _SeededDraws(seed)
        self.sesize = sesize
        self.use_segment = use_segment

    def __getitem__(self, item):
        story_id = self.srt + item
        t = int(self._draws.child().integers(1, self.video_len + 1))
        image = normalize_image(
            np.array(Image.open(_frame(self.dir_path, story_id, t)).convert("RGB")), self.imsize)
        content, attr, label = [], None, None
        for tt in range(1, self.video_len + 1):
            code = self._code(story_id, tt)
            attr = code if attr is None else np.maximum(attr, code)
            content.append(code)
            if tt == t:
                label = attr[2:10].astype(np.float32)  # the 8-d cumulative label
        out = {
            "images": image,
            "description": self._code(story_id, t),
            "labels": label,
            "content": np.stack(content),
            "text": "clevr %d frame %d" % (story_id, t),
        }
        if self.use_segment:
            mask = Image.open(_frame(self.dir_path, story_id, t, "_mask")).convert("L")
            out["images_seg"] = normalize_image(np.array(mask), self.sesize)
        return out
