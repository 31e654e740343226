"""CLI flags shared by the entry points and the branch that runs what they ask
for (counterpart of `cpcsv_tpu/cli/dispatch.py`; reference
`main_pororo.py:152-171`).

The ladder keeps the reference's order, eval flags before --load_ckpt before
training: --eval_fid, --eval_fvd, --eval_is, --eval_ssim, the first given
wins. --eval_is and --eval_ssim are the JAX package's: the reference ships
both scores and wires neither to its CLI.
"""

from __future__ import annotations

import argparse
import os


def _str2bool(v: str) -> bool:
    """Strict boolean flag parser: the JAX package's fix for the reference's
    argparse type=bool, which parses "0" and "False" as True
    (main_pororo.py:39-40)."""
    if v.lower() in ("1", "true", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_eval_flags(parser):
    """--eval_fid, --eval_fvd, --eval_is, --eval_ssim."""
    for flag in ("--eval_fid", "--eval_fvd", "--eval_is", "--eval_ssim"):
        parser.add_argument(flag, type=_str2bool, nargs="?", const=True, default=False)
    return parser


def add_debug_flag(parser):
    """--debug, bare or with a value (the reference's form is `--debug 1`)."""
    parser.add_argument("--debug", type=_str2bool, nargs="?", const=True, default=False)
    return parser


def add_compat_flags(parser):
    """--gpu (dest gpu_id): the reference parses it and never reads it
    (main_pororo.py:37); accepted and ignored, as there."""
    parser.add_argument("--gpu", dest="gpu_id", type=str, default="")
    return parser


def add_device_flag(parser):
    """--device: where the port runs, "cuda" unless the caller asks for "cpu";
    --backend: a multi-process run's torch.distributed backend (default NCCL
    on CUDA, gloo on the CPU)."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu, the plain PyTorch path")
    parser.add_argument("--backend", type=str, default=None, choices=("nccl", "gloo"),
                        help="process group backend of a multi-process run")
    return parser


# the evaluation flags in the ladder's order, each with its `Infer` walk
WALKS = (("eval_fid", "eval_fid2"), ("eval_fvd", "eval_fvd"), ("eval_is", "eval_is"),
         ("eval_ssim", "eval_ssim_walk"))


def _walk(args):
    return next((method for flag, method in WALKS if getattr(args, flag)), None)


def loader_shard(args):
    """The data shard the CLI's loaders read (`data.loader.training_loaders`):
    None, the training mesh's, for a training run; (rank, world) for the
    walks and --load_ckpt's dump, which read the test set whole on rank 0
    and take any well-formed mesh."""
    if _walk(args) is None and args.load_ckpt is None:
        return None
    from cpcsv_tpu_torch.parallel.distributed import process_info

    return process_info()


def dispatch(cfg, args, output_dir, imageloader, storyloader, testloader):
    """The reference's ladder: an evaluation walk, else --load_ckpt's sample
    dump, else training; the walks and the dump generate over the eval mesh
    of cfg.MESH_SHAPE on args.device's cards (`Infer`), training runs on
    args.device."""
    walk = _walk(args)
    if walk or args.load_ckpt is not None:
        from cpcsv_tpu_torch.evaluation.drivers import Infer

        if walk:
            infer = Infer(cfg, output_dir=output_dir, device=args.device)
            return getattr(infer, walk)(testloader)
        infer = Infer(cfg, output_dir=output_dir, device=args.device, load_ckpt=args.load_ckpt)
        return infer.inference_samples(
            testloader, os.path.join(output_dir, "Evaluation", "samples"))
    from cpcsv_tpu_torch.train.trainer import GANTrainer

    trainer = GANTrainer(cfg, output_dir, cfg_file=args.cfg_file,
                         continue_ckpt=args.continue_ckpt, seed=args.manualSeed,
                         device=args.device)
    return trainer.train(imageloader, storyloader, testloader)
