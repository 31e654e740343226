"""CLI flags shared by the entry points and the branch that runs what they ask
for (counterpart of `cpcsv_tpu/cli/dispatch.py`; reference
`main_pororo.py:152-171`).

The ladder keeps the reference's order, eval flags before --load_ckpt before
training. The port trains; the evaluation walks and --load_ckpt inference
raise until the evaluation slice brings them.
"""

from __future__ import annotations

import argparse


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
    """--device: where the port runs, "cuda" unless the caller asks for "cpu"."""
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu, the plain PyTorch path")
    return parser


def dispatch(cfg, args, output_dir, imageloader, storyloader, testloader):
    if (args.eval_fid or args.eval_fvd or args.eval_is or args.eval_ssim
            or args.load_ckpt is not None):
        raise NotImplementedError(
            "--eval_fid / --eval_fvd / --eval_is / --eval_ssim / --load_ckpt: the evaluation "
            "walks and checkpoint inference come with the evaluation slice; the port's CLI "
            "trains")
    from cpcsv_tpu_torch.train.trainer import GANTrainer

    trainer = GANTrainer(cfg, output_dir, cfg_file=args.cfg_file,
                         continue_ckpt=args.continue_ckpt, seed=args.manualSeed,
                         device=args.device)
    return trainer.train(imageloader, storyloader, testloader)
