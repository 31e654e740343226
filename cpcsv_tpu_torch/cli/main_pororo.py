"""Pororo CLI of the port: the JAX package's flag surface
(`cpcsv_tpu/cli/main_pororo.py`, itself the reference's `main_pororo.py:29-43`)
plus --device:

  python -m cpcsv_tpu_torch.cli.main_pororo --cfg CFG.yml
      (--data_dir DIR | --synthetic N)
      [--max_epoch E] [--continue_ckpt auto|E] [--debug] [--manualSeed S]
      [--eval_fid 1 | --eval_fvd 1 | --eval_is 1 | --eval_ssim 1 | --load_ckpt E]
      [--device cuda|cpu] [--backend nccl|gloo]

--data_dir (or the config's DATA_DIR) reads a Pororo-protocol dataset from
disk (`data/pororo.py`; `python -m cpcsv_tpu_torch.data.procedural DIR`
writes one); `--synthetic N` trains on the in-memory synthetic datasets
instead, built as the JAX package builds them. Runs go under
./output/torch/{CONFIG_NAME} (./output/torch/debug with --debug), apart from
the JAX package's ./output/..., so that the two never share a
last_epoch.txt; the evaluation flags walk the snapshots of that directory.

Data-parallel training runs one process a rank. This command starts them
itself, one a card of its host, as the JAX CLI trains over every device
(`parallel/launch.py`): with --device cuda and training, MESH_SHAPE ""
takes every visible card and a named mesh the product of its sizes (cards
0 .. W − 1; more than the host has raises); "data:1" keeps one card. Across
hosts the same command runs once on every host with CPCSV_COORDINATOR=
host:port (host 0's address), CPCSV_NUM_PROCESSES=H (the hosts) and
CPCSV_PROCESS_ID=h, the JAX package's variables: each starts one rank a
card of its host, rank h × L + l, "" is every card of every host and a
named mesh must take them all; every host must see the same number of
cards, and a rank that fails on one host ends every host's command. A
rank can also be started by hand (CPCSV_* and LOCAL_RANK, LOCAL_WORLD_SIZE,
as torchrun sets them) or under torchrun with CPCSV_DISTRIBUTED=1; a
process with CPCSV_* but no LOCAL_RANK and one visible card (or
--device cpu) is a host of one rank, its rank its host index. The
config's MESH_SHAPE ("", every rank on `data`, or named axes such as
"data:4,model:2") must have a `data` axis and span the ranks, the product
of its axis sizes. The batches in the config are each rank's, the global
batch W times them; a rank reads its shard on the `data` axis and the ranks
of the other axes replicate it, as the JAX package's mesh does (the same
global batch and numbers, no speed-up from the replicas). With
USE_SEQ_CONSISTENCY the story shuffle is the host's, as the JAX process's
(`train/trainer.py`). --backend names the process
group's backend (NCCL on CUDA, gloo on the CPU by default; gloo lets several
ranks share one GPU). Rank 0 alone writes the run directory, and the
evaluation walks run on rank 0 over the whole test set while the others
wait.

One process walks (--eval_*) and dumps (--load_ckpt) over an eval mesh of
the run's MESH_SHAPE, as the JAX CLI does: with --device cuda every card
of the host ("" or a mesh larger than the host), each generation call split
over its `data` axis (`evaluation/drivers.py:Infer`); a rank-0 walk in a
process group runs on its own card alone.
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
    start_ranks,
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


def synthetic_loaders(cfg, n: int, seed: int, shard=None):
    """(image, story, test) loaders over the synthetic datasets, as the JAX
    package's CLI builds them (main_pororo.py:73-102): at the global batches,
    each process reading its data shard (`data.loader.training_loaders`)."""
    from cpcsv_tpu_torch.data.loader import global_batches, training_loaders
    from cpcsv_tpu_torch.data.synthetic import SyntheticImageDataset, SyntheticStoryDataset

    im_bs, st_bs = global_batches(cfg)
    story = SyntheticStoryDataset(max(n, st_bs), cfg.VIDEO_LEN, cfg.IMSIZE,
                                  cfg.TEXT.DIMENSION, cfg.LABEL_NUM)
    image = SyntheticImageDataset(max(n * 2, im_bs), cfg.VIDEO_LEN, cfg.IMSIZE, cfg.SESIZE,
                                  cfg.TEXT.DIMENSION, cfg.LABEL_NUM,
                                  use_segment=cfg.SEGMENT_LEARNING)
    test = SyntheticStoryDataset(max(n // 4, st_bs), cfg.VIDEO_LEN, cfg.IMSIZE,
                                 cfg.TEXT.DIMENSION, cfg.LABEL_NUM, seed=99)
    return training_loaders(cfg, image, story, test, seed, shard)


def main(argv=None):
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.parallel.distributed import maybe_initialize_from_env

    args = parse_args(argv)
    cfg = config_from_file(args.cfg_file)
    # on several cards, a training run is one rank a card of the mesh
    if start_ranks(main, argv, args, cfg):
        return None
    # a rank joins its process group before anything else (nothing happens
    # unless CPCSV_COORDINATOR or CPCSV_DISTRIBUTED is set)
    maybe_initialize_from_env(args.backend, args.device)
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
        from cpcsv_tpu_torch.data.pororo import build_pororo_loaders

        loaders = build_pororo_loaders(cfg, args.manualSeed, loader_shard(args))
    else:
        raise ValueError(
            "no data: pass --data_dir DIR (or set DATA_DIR in the config) for the Pororo "
            "dataset loader, or --synthetic N for synthetic data")
    return dispatch(cfg, args, output_dir, *loaders)


if __name__ == "__main__":
    main()
