"""One-off preprocessing of a Pororo download (counterpart of
`cpcsv_tpu/data/preprocess.py`; reference `preprocess_pororo.py:9-103`):
the first frame of each `SceneDialogues/<episode>/*.gif` to a PNG, the
frames_counter dict, and the text-vector dict from a description CSV.
PIL and numpy; the CSV is read with the standard library."""

from __future__ import annotations

import csv
import os
from os.path import join

import numpy as np
from PIL import Image


def extract_frames(in_gif: str, out_png: str) -> int:
    """A GIF's first frame -> PNG (reference extractFrames)."""
    frame = Image.open(in_gif)
    frame.seek(0)
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    frame.convert("RGB").save(out_png)
    return 1


def _numeric_key(filename: str):
    """Temporal order for numbered files: 1, 2, ..., 10, not 1, 10, 2."""
    stem = filename.rsplit(".", 1)[0]
    try:
        return (0, int(stem), filename)
    except ValueError:
        return (1, 0, filename)


def extract_all(scene_dir: str, out_dir: str) -> int:
    """SceneDialogues/<episode>/*.gif -> <out_dir>/<episode>/{1..n}.png in
    numeric scene order; returns the frames written."""
    count = 0
    for ep in sorted(os.listdir(scene_dir)):
        ep_dir = join(scene_dir, ep)
        if not os.path.isdir(ep_dir):
            continue
        gifs = sorted((f for f in os.listdir(ep_dir) if f.endswith(".gif")), key=_numeric_key)
        for i, gif in enumerate(gifs):
            count += extract_frames(join(ep_dir, gif), join(out_dir, ep, f"{i + 1}.png"))
    return count


def build_frames_counter(img_dir: str, out_path: str | None = None) -> dict:
    """"/<episode>/" -> its PNG count (the frames_counter.npy artifact)."""
    counter = {}
    for ep in sorted(os.listdir(img_dir)):
        ep_dir = join(img_dir, ep)
        if not os.path.isdir(ep_dir):
            continue
        counter[f"/{ep}/"] = len([f for f in os.listdir(ep_dir) if f.endswith(".png")])
    if out_path:
        np.save(out_path, counter)  # read back with .item()
    return counter


def build_text_dict(csv_path: str, vec_lookup, out_path: str | None = None) -> dict:
    """id -> list of text vectors (the reference's obtain_pororo_dict), from a
    headerless CSV of (id, description) rows and `vec_lookup(text) ->
    np.ndarray`, the sentence encoder (the reference used a pretrained
    universal sentence encoder)."""
    out: dict[str, list[np.ndarray]] = {}
    with open(csv_path, newline="") as f:
        for frame_id, text in csv.reader(f):
            out.setdefault(frame_id, []).append(np.asarray(vec_lookup(text)))
    if out_path:
        np.save(out_path, out)
    return out
