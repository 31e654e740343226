"""CLEVR CLI of the port: the JAX package's flag surface
(`cpcsv_tpu/cli/main_clevr.py`, itself the reference's `main_clevr.py:39-139`)
plus --device, and the Pororo CLI's dispatch with the CLEVR loaders (4-frame
stories, 8-d labels, *_mask.png):

  python -m cpcsv_tpu_torch.cli.main_clevr [--cfg CFG.yml]
      (--data_dir DIR | --synthetic N)
      [--max_epoch E] [--continue_ckpt auto|E] [--debug] [--manualSeed S]
      [--eval_fid 1 | --eval_fvd 1 | --eval_is 1 | --eval_ssim 1 | --load_ckpt E]
      [--device cuda|cpu] [--backend nccl|gloo]

--cfg defaults to configs/clevr.yml. --data_dir (or the config's DATA_DIR)
reads a CLEVR-layout directory (`data/clevr.py`); `--synthetic N` trains on
the in-memory synthetic datasets at the config's VIDEO_LEN and dims instead.
The seeds are the JAX CLI's: manualSeed + 10 for the image dataset's frame
picks, manualSeed, + 1 and + 2 for the image, story and test loaders. Runs
go under ./output/torch/{CONFIG_NAME} (./output/torch/debug with --debug),
and the evaluation flags walk that directory's snapshots, over the eval
mesh of the run's MESH_SHAPE as the Pororo CLI's do. Several processes
train data-parallel as the Pororo CLI's do (`cli/main_pororo.py`).
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
    loader_shard,
)
from cpcsv_tpu_torch.cli.main_pororo import synthetic_loaders


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train CP-CSV on CLEVR (PyTorch/CUDA)")
    add_debug_flag(parser)
    parser.add_argument("--cfg", dest="cfg_file", type=str,
                        default=os.path.join(os.path.dirname(__file__), "..", "configs",
                                             "clevr.yml"))
    parser.add_argument("--load_ckpt", default=None, type=str)
    parser.add_argument("--continue_ckpt", default=None, type=str)
    parser.add_argument("--data_dir", dest="data_dir", type=str, default="")
    add_eval_flags(parser)
    add_compat_flags(parser)
    parser.add_argument("--manualSeed", type=int, default=0)
    parser.add_argument("--synthetic", type=int, default=0,
                        help="train on N synthetic samples instead of DATA_DIR")
    parser.add_argument("--max_epoch", type=int, default=None)
    add_device_flag(parser)
    return parser.parse_args(argv)


def clevr_loaders(cfg, seed: int, shard=None):
    """(image, story, test) loaders over the CLEVR directory cfg.DATA_DIR, as
    the JAX package's CLI builds them: at the global batches, each process
    reading its data shard (`data.loader.training_loaders`)."""
    from cpcsv_tpu_torch.data.clevr import ClevrImageDataset, ClevrStoryDataset
    from cpcsv_tpu_torch.data.loader import training_loaders

    story = ClevrStoryDataset(cfg.DATA_DIR, "train", cfg.VIDEO_LEN, cfg.IMSIZE)
    image = ClevrImageDataset(cfg.DATA_DIR, "train", cfg.VIDEO_LEN, cfg.IMSIZE, cfg.SESIZE,
                              use_segment=cfg.SEGMENT_LEARNING, seed=seed + 10)
    test = ClevrStoryDataset(cfg.DATA_DIR, "test", cfg.VIDEO_LEN, cfg.IMSIZE)
    return training_loaders(cfg, image, story, test, seed, shard)


def main(argv=None):
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.parallel.distributed import maybe_initialize_from_env

    args = parse_args(argv)
    maybe_initialize_from_env(args.backend, args.device)  # as the Pororo CLI
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
        loaders = synthetic_loaders(cfg, args.synthetic, args.manualSeed,
                                    loader_shard(args))
    elif cfg.DATA_DIR:
        loaders = clevr_loaders(cfg, args.manualSeed, loader_shard(args))
    else:
        raise ValueError(
            "no data: pass --data_dir DIR (or set DATA_DIR in the config) for the CLEVR "
            "dataset loader, or --synthetic N for synthetic data")
    return dispatch(cfg, args, output_dir, *loaders)


if __name__ == "__main__":
    main()
