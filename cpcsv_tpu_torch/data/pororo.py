"""The Pororo-SV dataset on disk (counterpart of `cpcsv_tpu/data/pororo.py`;
reference `datasets/pororo.py`), in the reference's artifact protocol:

  DATA_DIR/
    <episode dirs>/<frame>.png      vertical strips of square frames
    labels.npy                      dict id -> 9-dim character one-hot
    frames_counter.npy              dict "<episode>/" -> frame count
                                    (leading-slash keys also accepted)
    img_cache4.npy following_cache4.npy   clip index caches
    train_test_ids.npy              (train_ids, test_ids)
    descriptions_vec.npy (128-d), descriptions_attr.npy (228-d),
    subtitles_vec.npy, descriptions.npy (raw text)
    img_segment/ (or img_segment_refine/) figure-ground masks

Items are dicts of numpy arrays, images HWC float32 in [-1, 1] and videos
(T, H, W, C), the same bits as the JAX package's for the same (seed, epoch):
the loader moves them to the device. `data/procedural.py` writes such a
dataset.
"""

from __future__ import annotations

import os
import re
import threading
import uuid
from os.path import exists, join

import numpy as np
from PIL import Image

from cpcsv_tpu_torch.data.transforms import normalize_image, video_transform


def _load_npy_dict(path):
    return np.load(path, allow_pickle=True, encoding="latin1").item()


def _decode(v) -> str:
    if isinstance(v, bytes):
        return v.decode("utf-8")
    v = str(v)
    if v.startswith("b'") or v.startswith('b"'):
        return v[2:-1]
    return v


def _frame_keyed(d: dict) -> dict:
    """Frame-id keys in the no-leading-slash form ("ep/1"), so artifacts
    written under either DATA_DIR slash convention load alike."""
    return {_decode(k).lstrip("/"): v for k, v in d.items()}


class _SeededDraws:
    """A dataset's random draws: one master numpy stream from the seed, and
    a child stream per item read. `reseed(epoch)` derives the master from
    (seed, epoch), so a resumed epoch E draws the crops and descriptions of
    an uninterrupted run's epoch E. Thread-safe: the loader's producer
    thread reads the items."""

    def __init__(self, seed: int):
        self._seed = seed
        self._master = np.random.default_rng(seed)
        self._lock = threading.Lock()

    def reseed(self, epoch: int) -> None:
        with self._lock:
            self._master = np.random.default_rng([self._seed, epoch])

    def child(self) -> np.random.Generator:
        with self._lock:
            return np.random.default_rng(int(self._master.integers(0, 2**63)))


def _atomic_save(path: str, arr: np.ndarray) -> None:
    """np.save to a uniquely named temporary file, then os.replace over
    `path`: a reader never sees a partial cache, whoever writes beside it."""
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    np.save(tmp, arr)  # appends .npy to the name
    os.replace(f"{tmp}.npy", path)


class VideoFolderDataset:
    """The clip index (reference `datasets/pororo.py:12-68`): every frame with
    at least `min_len` successors in its episode, cached in
    `img_cache{min_len}.npy` / `following_cache{min_len}.npy` in the dataset
    directory, then split train / test."""

    def __init__(self, folder, counter=None, min_len=4, data_type="train"):
        if data_type not in ("train", "test", "valid"):
            raise ValueError(f"data_type {data_type!r}: expected train, test or valid")
        # a trailing separator, the reference's form: frame names are stored
        # as "<ep>/<n>.png" and read as dir_path + name
        folder = folder.rstrip(os.sep) + os.sep
        self.dir_path = folder
        self.labels = _frame_keyed(_load_npy_dict(join(folder, "labels.npy")))

        img_cache = join(folder, f"img_cache{min_len}.npy")
        follow_cache = join(folder, f"following_cache{min_len}.npy")
        if exists(img_cache) and exists(follow_cache):
            self.images = np.load(img_cache, allow_pickle=True, encoding="latin1")
            self.followings = np.load(follow_cache, allow_pickle=True, encoding="latin1")
        else:
            images, followings = self._build_index(folder, counter, min_len)
            if not images:
                raise RuntimeError(
                    f"Pororo clip index is EMPTY for {folder!r}: check DATA_DIR and the "
                    "frames_counter.npy keys (an empty index is not cached)")
            self.images = np.array(images, dtype=object)
            self.followings = np.array(followings, dtype=object)
            _atomic_save(img_cache, self.images)
            _atomic_save(follow_cache, self.followings)

        train_id, test_id = np.load(
            join(folder, "train_test_ids.npy"), allow_pickle=True, encoding="latin1")
        orders = np.array(train_id if data_type == "train" else test_id).astype("int32")
        self.images = self.images[orders]
        self.followings = self.followings[orders]

    @staticmethod
    def _build_index(folder, counter, min_len):
        """(frame names, their `min_len` successors) in sorted directory order;
        frames_counter keys with and without a leading slash both match."""
        images, followings = [], []
        if counter is not None:
            counter = {str(k).lstrip("/"): v for k, v in counter.items()}
        entries = []
        for d in sorted(os.listdir(folder)):
            full = join(folder, d)
            if not os.path.isdir(full):
                continue
            for f in sorted(os.listdir(full)):
                if f.endswith(".png"):
                    entries.append(join(full, f))
        for img_path in entries:
            v_name = img_path.replace(folder, "")  # "<ep>/<n>.png"
            episode = re.sub(r"[0-9]+.png", "", v_name)
            if counter is None or episode not in counter:
                continue  # not an episode directory (img_segment/, ...)
            try:
                frame_id = int(os.path.basename(v_name).replace(".png", ""))
            except ValueError:
                continue
            if frame_id > counter[episode] - min_len:
                continue
            followings.append([episode + str(frame_id + i + 1) + ".png" for i in range(min_len)])
            images.append(v_name)
        return images, followings

    def sample_image(self, im, rng):
        """One random square frame of a vertical strip (reference
        `datasets/pororo.py:54-58`)."""
        shorter, longer = min(im.size), max(im.size)
        se = int(rng.integers(0, longer // shorter))
        return im.crop((0, se * shorter, shorter, (se + 1) * shorter))

    def __getitem__(self, item):
        return [self.images[item]] + [str(f) for f in self.followings[item]]

    def __len__(self):
        return len(self.images)


class _TextArtifacts:
    """The four text dicts, loaded once and shared by the datasets."""

    def __init__(self, textvec):
        self.descriptions = _frame_keyed(_load_npy_dict(join(textvec, "descriptions_vec.npy")))
        self.attributes = _frame_keyed(_load_npy_dict(join(textvec, "descriptions_attr.npy")))
        self.subtitles = _frame_keyed(_load_npy_dict(join(textvec, "subtitles_vec.npy")))
        self.descriptions_original = _frame_keyed(
            _load_npy_dict(join(textvec, "descriptions.npy")))

    def pick(self, rng, frame_id):
        """A random description index where a frame has several. The draw is
        sized by the raw-text list (reference pororo.py:126,205) and applied
        to the embedded lists; ImageDataset's content loop sizes it by the
        embedded list instead (reference :224-225). Both are kept."""
        n = len(self.descriptions_original[frame_id])
        return int(rng.integers(0, n)) if n > 1 else 0


class StoryDataset:
    """5-frame stories (reference `datasets/pororo.py:70-154`)."""

    def __init__(self, dataset: VideoFolderDataset, textvec, imsize: int = 64, seed: int = 0):
        self.dataset = dataset
        self.dir_path = dataset.dir_path
        # a directory, or _TextArtifacts already loaded
        self.text = textvec if isinstance(textvec, _TextArtifacts) else _TextArtifacts(textvec)
        self.labels = dataset.labels
        self.imsize = imsize
        self._draws = _SeededDraws(seed)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        rng = self._draws.child()
        frames, des, subs, labels, attri, raw = [], [], [], [], [], []
        for v in self.dataset[item]:
            frame_id = _decode(v).lstrip("/").replace(".png", "")
            im = Image.open(self.dir_path + frame_id + ".png").convert("RGB")
            frames.append(np.array(self.dataset.sample_image(im, rng)))
            se = self.text.pick(rng, frame_id)
            raw.append(self.text.descriptions_original[frame_id][se])
            des.append(self.text.descriptions[frame_id][se])
            subs.append(self.text.subtitles[frame_id][0])
            labels.append(self.labels[frame_id])
            attri.append(self.text.attributes[frame_id][se].astype("float32"))
        return {
            "images": video_transform(np.stack(frames), self.imsize),  # (T, H, W, C)
            "text": raw,
            "description": np.concatenate(  # (T, 128 + 228 = 356)
                [np.stack(des), np.stack(attri)], axis=1).astype(np.float32),
            "subtitle": np.stack(subs).astype(np.float32),
            "labels": np.stack(labels).astype(np.float32),
        }


class ImageDataset:
    """Single frames, their story's content matrix, and the frame's segment
    mask when `use_segment` (reference `datasets/pororo.py:157-248`)."""

    def __init__(
        self,
        dataset: VideoFolderDataset,
        textvec,
        imsize: int = 64,
        sesize: int = 64,
        use_segment: bool = False,
        segment_name: str = "img_segment",
        seed: int = 0,
    ):
        self.dataset = dataset
        self.dir_path = dataset.dir_path
        self.text = textvec if isinstance(textvec, _TextArtifacts) else _TextArtifacts(textvec)
        self.labels = dataset.labels
        self.imsize = imsize
        self.sesize = sesize
        self.use_segment = use_segment
        self.segment_name = segment_name
        self._draws = _SeededDraws(seed)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, item):
        # the mask and the image each draw their own strip crop, as in the
        # reference (pororo.py:54-58,181-189)
        rng = self._draws.child()
        lists = self.dataset[item]
        sub_path = _decode(lists[0]).lstrip("/")
        frame_id = sub_path.replace(".png", "")

        out = {}
        if self.use_segment:
            seg_path = "{}/{}/{}".format(
                self.dir_path, self.segment_name, "_".join(sub_path.split("/")[-2:]))
            seg = Image.open(seg_path).convert("L")
            out["images_seg"] = normalize_image(
                np.array(self.dataset.sample_image(seg, rng)), self.sesize)

        im = Image.open(self.dir_path + sub_path).convert("RGB")
        out["images"] = normalize_image(np.array(self.dataset.sample_image(im, rng)), self.imsize)

        se = self.text.pick(rng, frame_id)
        des = self.text.descriptions[frame_id][se]
        attri = self.text.attributes[frame_id][se].astype("float32")
        out["description"] = np.concatenate([des, attri]).astype(np.float32)
        out["subtitle"] = np.asarray(self.text.subtitles[frame_id][0], np.float32)
        out["labels"] = self.labels[frame_id].astype(np.float32)
        out["text"] = self.text.descriptions_original[frame_id][se]

        content, attri_c, label_c = [], [], []
        for v in lists:
            vid = _decode(v).lstrip("/").replace(".png", "")
            # sized by the embedded list here (see _TextArtifacts.pick)
            n = len(self.text.descriptions[vid])
            se = int(rng.integers(0, n)) if n > 1 else 0
            content.append(self.text.descriptions[vid][se])
            attri_c.append(self.text.attributes[vid][se].astype("float32"))
            label_c.append(self.labels[vid].astype("float32"))
        out["content"] = np.concatenate(  # (T, 128 + 228 + 9 = 365)
            [np.stack(content), np.stack(attri_c), np.stack(label_c)], axis=1).astype(np.float32)
        return out


def build_pororo_loaders(cfg, seed: int = 0, shard=None):
    """(image, story, test) loaders over cfg.DATA_DIR (reference
    main_pororo.py:97-121), at the global batches (the config's times
    mesh_size(MESH_SHAPE)), each process reading its data shard
    (`data.loader.training_loaders`, `cpcsv_tpu/data/pororo.py:329-364`). The datasets draw from seed + 10,
    11, 12 and the loaders shuffle from seed, + 1, + 2."""
    from cpcsv_tpu_torch.data.loader import training_loaders

    dir_path = cfg.DATA_DIR
    counter = _load_npy_dict(join(dir_path, "frames_counter.npy"))
    base = VideoFolderDataset(dir_path, counter, min_len=4, data_type="train")
    text = _TextArtifacts(dir_path)
    story = StoryDataset(base, text, cfg.IMSIZE, seed=seed + 10)
    image = ImageDataset(base, text, cfg.IMSIZE, cfg.SESIZE, use_segment=cfg.SEGMENT_LEARNING,
                         segment_name=cfg.TRAIN.SEGMENT_NAME, seed=seed + 11)
    base_test = VideoFolderDataset(dir_path, counter, min_len=4, data_type="test")
    test_story = StoryDataset(base_test, text, cfg.IMSIZE, seed=seed + 12)
    return training_loaders(cfg, image, story, test_story, seed, shard)
