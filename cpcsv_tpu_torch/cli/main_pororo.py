"""Pororo CLI of the port: the JAX package's flag surface
(`cpcsv_tpu/cli/main_pororo.py`, itself the reference's `main_pororo.py:29-43`)
plus --device:

  python -m cpcsv_tpu_torch.cli.main_pororo --cfg CFG.yml
      (--data_dir DIR | --synthetic N)
      [--max_epoch E] [--continue_ckpt auto|E] [--debug] [--manualSeed S]
      [--eval_fid 1 | --eval_fvd 1 | --eval_is 1 | --eval_ssim 1 | --load_ckpt E]
      [--device cuda|cpu]

--data_dir (or the config's DATA_DIR) reads a Pororo-protocol dataset from
disk (`data/pororo.py`; `python -m cpcsv_tpu_torch.data.procedural DIR`
writes one); `--synthetic N` trains on the in-memory synthetic datasets
instead, built as the JAX package builds them. Runs go under
./output/torch/{CONFIG_NAME} (./output/torch/debug with --debug), apart from
the JAX package's ./output/..., so that the two never share a
last_epoch.txt; the evaluation flags walk the snapshots of that directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pprint

from cpcsv_tpu_torch.cli.dispatch import (
    add_compat_flags,
    add_debug_flag,
    add_device_flag,
    add_eval_flags,
    dispatch,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train a CP-CSV story GAN (PyTorch/CUDA)")
    add_debug_flag(parser)
    parser.add_argument("--cfg", dest="cfg_file", type=str,
                        default=os.path.join(os.path.dirname(__file__), "..", "configs",
                                             "final.yml"))
    parser.add_argument("--load_ckpt", default=None, type=str)
    parser.add_argument("--continue_ckpt", default=None, type=str)
    parser.add_argument("--data_dir", dest="data_dir", type=str, default="")
    add_eval_flags(parser)
    add_compat_flags(parser)
    parser.add_argument("--manualSeed", type=int, default=0)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples instead of DATA_DIR")
    parser.add_argument("--max_epoch", type=int, default=None,
                        help="override TRAIN.MAX_EPOCH (smoke runs)")
    add_device_flag(parser)
    return parser.parse_args(argv)


def synthetic_loaders(cfg, n: int, seed: int):
    """(image, story, test) loaders over the synthetic datasets, as the JAX
    package's CLI builds them for one device (main_pororo.py:73-102)."""
    from cpcsv_tpu_torch.data.loader import DataLoader
    from cpcsv_tpu_torch.data.synthetic import SyntheticImageDataset, SyntheticStoryDataset

    im_bs, st_bs = cfg.TRAIN.IM_BATCH_SIZE, cfg.TRAIN.ST_BATCH_SIZE
    story = SyntheticStoryDataset(max(n, st_bs), cfg.VIDEO_LEN, cfg.IMSIZE,
                                  cfg.TEXT.DIMENSION, cfg.LABEL_NUM)
    image = SyntheticImageDataset(max(n * 2, im_bs), cfg.VIDEO_LEN, cfg.IMSIZE, cfg.SESIZE,
                                  cfg.TEXT.DIMENSION, cfg.LABEL_NUM,
                                  use_segment=cfg.SEGMENT_LEARNING)
    test = SyntheticStoryDataset(max(n // 4, st_bs), cfg.VIDEO_LEN, cfg.IMSIZE,
                                 cfg.TEXT.DIMENSION, cfg.LABEL_NUM, seed=99)
    return (DataLoader(image, im_bs, shuffle=True, drop_last=True, seed=seed),
            DataLoader(story, st_bs, shuffle=True, drop_last=True, seed=seed + 1),
            DataLoader(test, st_bs, shuffle=False, drop_last=True, seed=seed + 2))


def main(argv=None):
    from cpcsv_tpu_torch.config import config_from_file

    args = parse_args(argv)
    cfg = config_from_file(args.cfg_file)
    if args.data_dir:
        cfg = cfg.with_updates(DATA_DIR=args.data_dir)
    if args.max_epoch is not None:
        cfg = cfg.with_updates(TRAIN=dataclasses.replace(cfg.TRAIN, MAX_EPOCH=args.max_epoch))
    print("Using config:")
    pprint.pprint(cfg)

    output_dir = os.path.join(".", "output", "torch",
                              "debug" if args.debug else cfg.CONFIG_NAME)
    if args.synthetic:
        loaders = synthetic_loaders(cfg, args.synthetic, args.manualSeed)
    elif cfg.DATA_DIR:
        from cpcsv_tpu_torch.data.pororo import build_pororo_loaders

        loaders = build_pororo_loaders(cfg, args.manualSeed)
    else:
        raise ValueError(
            "no data: pass --data_dir DIR (or set DATA_DIR in the config) for the Pororo "
            "dataset loader, or --synthetic N for synthetic data")
    return dispatch(cfg, args, output_dir, *loaders)


if __name__ == "__main__":
    main()
