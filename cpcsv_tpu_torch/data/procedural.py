"""A procedural dataset in the Pororo protocol (counterpart of
`cpcsv_tpu/data/procedural.py`): episode directories of frame PNGs,
labels.npy, frames_counter.npy, descriptions{_vec,_attr,}.npy,
subtitles_vec.npy, train_test_ids.npy and img_segment/ masks, exactly what
`data/pororo.py` reads, so the CLI trains and walks on it with --data_dir.

    python -m cpcsv_tpu_torch.data.procedural DIR [--episodes 48] [--frames 19]

The world: 9 characters (a colour and a shape each, the LABEL_NUM = 9 slots
of Pororo). An episode casts 1-3 of them, each on a smooth trajectory with
its own size and brightness, over a dark background. The labels say which
characters appear, the 128-d description which, where, how large and how
bright, the 228-d attributes size and brightness; consecutive frames move
coherently and the masks are the exact union of the shapes. Everything comes
from numpy streams keyed on (seed, episode): the same seed writes the same
bits, and the same dataset as the JAX package's writer.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np
from PIL import Image

# 9 characters: (name, shape, RGB), far apart in colour
CHARACTERS = (
    ("red-circle", "circle", (220, 55, 45)),
    ("green-square", "square", (60, 200, 75)),
    ("blue-triangle", "triangle", (55, 90, 225)),
    ("yellow-circle", "circle", (235, 210, 60)),
    ("magenta-square", "square", (205, 65, 205)),
    ("cyan-triangle", "triangle", (65, 205, 215)),
    ("orange-circle", "circle", (240, 145, 45)),
    ("purple-square", "square", (135, 70, 220)),
    ("white-triangle", "triangle", (235, 235, 235)),
)

MIN_LEN = 4  # successors a clip needs (VIDEO_LEN = MIN_LEN + 1 = 5)
DESC_DIM, ATTR_DIM, SUB_DIM = 128, 228, 128  # the Pororo artifacts' vector widths


def _shape_mask(shape: str, size: int, cx: float, cy: float, r: float):
    """Boolean raster of one shape on a size x size grid."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    dx, dy = x - cx, y - cy
    if shape == "circle":
        return dx * dx + dy * dy <= r * r
    if shape == "square":
        return np.maximum(np.abs(dx), np.abs(dy)) <= r
    # upward triangle: apex at cy - r, base at cy + r
    return (dy >= -r) & (dy <= r) & (np.abs(dx) <= (dy + r) / 2.0)


def _episode_cast(rng: np.random.Generator, ep: int):
    """An episode's cast (1-3 characters, every size equally often) and, for
    each, a trajectory (start, velocity, sinusoidal wobble), size and
    brightness; and its background colour."""
    n_cast = 1 + ep % 3
    cast = sorted(rng.choice(len(CHARACTERS), size=n_cast, replace=False).tolist())
    params = []
    for c in cast:
        params.append({
            "char": int(c),
            "x0": float(rng.uniform(14, 50)),
            "y0": float(rng.uniform(14, 50)),
            "vx": float(rng.uniform(-1.6, 1.6)),
            "vy": float(rng.uniform(-1.6, 1.6)),
            "amp": float(rng.uniform(0.0, 3.0)),
            "freq": float(rng.uniform(0.3, 0.9)),
            "phase": float(rng.uniform(0, 2 * np.pi)),
            "radius": float(rng.uniform(6.0, 11.0)),
            "bright": float(rng.uniform(0.65, 1.0)),
        })
    bg = rng.uniform(15, 55, size=3)
    return params, bg


def _char_pos(p: dict, t: int, size: int):
    """A character's position at frame t, kept inside the frame."""
    margin = p["radius"] + 1.0
    x = p["x0"] + p["vx"] * t + p["amp"] * np.sin(p["freq"] * t + p["phase"])
    y = p["y0"] + p["vy"] * t + p["amp"] * np.cos(p["freq"] * t + p["phase"])
    return float(np.clip(x, margin, size - margin)), float(np.clip(y, margin, size - margin))


def render_frame(params, bg, t: int, size: int):
    """(frame uint8 HWC, mask uint8 HW) of an episode's frame t."""
    img = np.broadcast_to(np.asarray(bg, np.float32).reshape(1, 1, 3), (size, size, 3)).copy()
    seg = np.zeros((size, size), np.float32)
    for p in params:  # drawn in cast order
        cx, cy = _char_pos(p, t, size)
        m = _shape_mask(CHARACTERS[p["char"]][1], size, cx, cy, p["radius"])
        img[m] = np.asarray(CHARACTERS[p["char"]][2], np.float32) * p["bright"]
        seg[m] = 255.0
    return img.astype(np.uint8), seg.astype(np.uint8)


def _frame_vectors(params, t: int, size: int):
    """(description 128-d, attributes 228-d, label 9-d, raw text) of a frame.
    Character c owns description dims [5c, 5c + 5) = (present, x / size,
    y / size, radius / 16, brightness) and attribute dims [2c, 2c + 2) =
    (radius / 16, brightness); the rest stay 0."""
    desc = np.zeros(DESC_DIM, np.float32)
    attr = np.zeros(ATTR_DIM, np.float32)
    label = np.zeros(len(CHARACTERS), np.float32)
    words = []
    for p in params:
        c = p["char"]
        cx, cy = _char_pos(p, t, size)
        desc[5 * c : 5 * c + 5] = (1.0, cx / size, cy / size, p["radius"] / 16.0, p["bright"])
        attr[2 * c : 2 * c + 2] = (p["radius"] / 16.0, p["bright"])
        label[c] = 1.0
        words.append(f"{CHARACTERS[c][0]}@({cx:.0f},{cy:.0f})")
    return desc, attr, label, " ".join(words)


def write_procedural_pororo(
    root: str,
    n_episodes: int = 48,
    frames_per_episode: int = 19,
    size: int = 64,
    seed: int = 0,
    test_frac: float = 0.15,
) -> dict:
    """Write the dataset under `root` (created if needed); returns a summary.
    Point --data_dir (DATA_DIR) at `root`."""
    if frames_per_episode <= MIN_LEN:
        raise ValueError(f"frames_per_episode={frames_per_episode}: an episode needs more "
                         f"than {MIN_LEN} frames to yield a clip")
    seg_dir = join(root, "img_segment")
    os.makedirs(seg_dir, exist_ok=True)

    labels, counter = {}, {}
    desc_vec, desc_attr, subs, desc_raw = {}, {}, {}, {}
    for ep in range(n_episodes):
        ep_name = f"ep{ep:03d}"
        ep_dir = join(root, ep_name)
        os.makedirs(ep_dir, exist_ok=True)
        params, bg = _episode_cast(np.random.default_rng([seed, ep]), ep)
        counter[ep_name + "/"] = frames_per_episode
        # frames are numbered from 1, as the reference's: the clip index keeps
        # frame_id <= counter - MIN_LEN, whose successors reach frame_id + MIN_LEN
        for t in range(1, frames_per_episode + 1):
            frame_id = f"{ep_name}/{t}"
            img, seg = render_frame(params, bg, t, size)
            Image.fromarray(img).save(join(ep_dir, f"{t}.png"))
            # "<ep>_<n>.png" under img_segment/, as ImageDataset reads it
            Image.fromarray(seg).save(join(seg_dir, f"{ep_name}_{t}.png"))
            d, a, lab, raw = _frame_vectors(params, t, size)
            labels[frame_id] = lab
            desc_vec[frame_id] = np.stack([d])  # one description a frame
            desc_attr[frame_id] = np.stack([a])
            subs[frame_id] = np.zeros((1, SUB_DIM), np.float32)
            desc_raw[frame_id] = [raw]

    for name, d in (("labels", labels), ("frames_counter", counter),
                    ("descriptions_vec", desc_vec), ("descriptions_attr", desc_attr),
                    ("subtitles_vec", subs), ("descriptions", desc_raw)):
        np.save(join(root, f"{name}.npy"), np.array(d, dtype=object))

    # the split: indices into the clip index, n_episodes * (F - MIN_LEN) clips
    total = n_episodes * (frames_per_episode - MIN_LEN)
    order = np.random.default_rng([seed, 10_000]).permutation(total)
    n_test = max(1, int(round(total * test_frac)))
    train_ids = np.sort(order[n_test:]).astype(np.int64)
    test_ids = np.sort(order[:n_test]).astype(np.int64)
    np.save(join(root, "train_test_ids.npy"), np.array([train_ids, test_ids], dtype=object))
    return {
        "root": root,
        "episodes": n_episodes,
        "frames": n_episodes * frames_per_episode,
        "clips": total,
        "train_clips": int(train_ids.size),
        "test_clips": int(test_ids.size),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write a procedural Pororo-protocol dataset")
    ap.add_argument("root", help="output DATA_DIR")
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--frames", type=int, default=19)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    print(write_procedural_pororo(args.root, args.episodes, args.frames, args.size, args.seed))


if __name__ == "__main__":
    main()
