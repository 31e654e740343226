"""Checkpoints and resume, in `torch.save` files (counterpart of
`cpcsv_tpu/train/checkpoint.py`; reference miscc/utils.py:323-338,
trainer.py:121-131,482-485). In `Model/`:

  netG_epoch_{E}.pth           the generator's state_dict, reference layout
                               (BN running statistics included), one a snapshot
  netD_{im,st,se}_epoch_last.pth  the discriminators' state_dicts, overwritten
                               (no netD_se without SEGMENT_LEARNING; the story
                               D's VideoEncoder inside netD_st)
  train_state_last.pth         the full state: the nets (BN statistics, SN u
                               and v), their Adam states and the step count,
                               labelled COMPLETED_EPOCH inside the file
  last_epoch.txt               the completed epoch, for people

Every file is written to `<name>.tmp`, synced, and renamed over its final
name with one `os.replace`, so a kill at any instant leaves either the old
file or the new one under the final name, never a part of one. The full
state's label is also the comment of its zip archive (the format
`torch.save` writes), so `last_epoch` reads it without unpickling the file.

The Adam states are saved with their first moments in cfg.ADAM_MU_DTYPE;
restoring casts them to the dtype the state's optimizers were built with
(`train.state.Adam.load_state_dict`), as `cpcsv_tpu/train/checkpoint.py:241-250`
casts to the template, so a run may flip the key between resumes. A state
saved by `torch.optim.Adam` loads as it is.

In a process group rank 0 alone writes, and every rank meets the others at a
host barrier after the last swap (`mesh.host_barrier`), so no rank reads a
checkpoint before it is whole; every rank restores.

Resume is exact: the trainer draws every epoch's noise and data order from
(seed, epoch), so a resumed epoch E sees what an uninterrupted run's would.
The one state not saved is the image loader's wrap-around position inside an
epoch, as in the JAX package (the reference saves no loader state at all).
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import torch

from cpcsv_tpu_torch.parallel.distributed import process_info
from cpcsv_tpu_torch.parallel.mesh import host_barrier
from cpcsv_tpu_torch.train.state import TrainState

_LABEL = "COMPLETED_EPOCH"
STATE_FILE = "train_state_last.pth"
D_FILES = {"d_im": "netD_im_epoch_last.pth", "d_st": "netD_st_epoch_last.pth",
           "d_se": "netD_se_epoch_last.pth"}


def _cpu_state_dict(net) -> dict:
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def _replace_synced(tmp: str, final: str) -> None:
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, final)


class CheckpointManager:
    def __init__(self, model_dir: str):
        self.model_dir = os.path.abspath(model_dir)
        os.makedirs(self.model_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.model_dir, name)

    # ------------------------------------------------------------------ save
    def save(self, state: TrainState, epoch: int, completed: Optional[int] = None) -> None:
        """netG_epoch_{epoch}, the discriminators, and the full state labelled
        `completed` (default `epoch`). The end-of-run save keeps the
        reference's name netG_epoch_{MAX_EPOCH} with completed = MAX_EPOCH-1,
        so a rerun with a larger MAX_EPOCH resumes at MAX_EPOCH and skips no
        epoch. Rank 0 writes; every rank returns after the files are whole."""
        try:
            if process_info()[0] == 0:
                self._write(state, epoch, epoch if completed is None else completed)
        finally:  # a failed write still releases the other ranks
            host_barrier()

    def _write(self, state: TrainState, epoch: int, completed: int) -> None:
        self.save_generator(_cpu_state_dict(state.gen), epoch)
        nets = state.nets()
        for name, fname in D_FILES.items():
            if name not in nets:
                continue
            path = self._path(fname)
            torch.save(_cpu_state_dict(nets[name]), path + ".tmp")
            _replace_synced(path + ".tmp", path)
        self._save_state(state, completed)
        marker = self._path("last_epoch.txt")
        with open(marker + ".tmp", "w") as f:
            f.write(str(completed))
        _replace_synced(marker + ".tmp", marker)

    def _save_state(self, state: TrainState, completed: int) -> None:
        final = self._path(STATE_FILE)
        tmp = final + ".tmp"
        torch.save({
            _LABEL: int(completed),
            "step": int(state.step),
            "nets": {name: _cpu_state_dict(net) for name, net in state.nets().items()},
            "opts": {name: opt.state_dict() for name, opt in state.opts.items()},
        }, tmp)
        with zipfile.ZipFile(tmp, "a") as archive:
            archive.comment = f"{_LABEL}={int(completed)}".encode()
        _replace_synced(tmp, final)

    def save_generator(self, state_dict: dict, epoch: int) -> None:
        final = self._path(f"netG_epoch_{epoch}.pth")
        torch.save(state_dict, final + ".tmp")
        _replace_synced(final + ".tmp", final)

    # --------------------------------------------------------------- restore
    def restore(self, state: TrainState, epoch: Optional[int] = None) -> TrainState:
        """Loads the full state into `state` in place; with `epoch`, the
        generator then from netG_epoch_{epoch} (reference --continue_ckpt)."""
        path = self._path(STATE_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {STATE_FILE} in {self.model_dir}")
        # fresh tensors on every restore: the optimizers take the loaded
        # moments as they are (or copy them to the card), so no restored
        # state shares memory with another
        payload = torch.load(path, map_location="cpu", weights_only=True)
        if set(payload["nets"]) != set(state.nets()):
            raise ValueError(f"{path} holds the nets {sorted(payload['nets'])}, the config "
                             f"builds {sorted(state.nets())}: another SEGMENT_LEARNING")
        for name, net in state.nets().items():
            net.load_state_dict(payload["nets"][name], strict=True)
        for name, opt in state.opts.items():
            opt.load_state_dict(payload["opts"][name])
        state.step = payload["step"]
        if epoch is not None:
            state.gen.load_state_dict(self.restore_generator(epoch), strict=True)
        return state

    def restore_generator(self, epoch: int) -> dict:
        """netG_epoch_{epoch}'s state_dict on the CPU."""
        path = self._path(f"netG_epoch_{epoch}.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"generator snapshot not found: {path} (available epochs: "
                f"{self.available_generator_epochs()})")
        return torch.load(path, map_location="cpu", weights_only=True)

    def last_epoch(self) -> Optional[int]:
        """The last completed epoch, the full state's label; None before the
        first save."""
        path = self._path(STATE_FILE)
        if not os.path.exists(path):
            return None
        with zipfile.ZipFile(path) as archive:
            return int(archive.comment.decode().removeprefix(f"{_LABEL}="))

    def available_generator_epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.model_dir):
            tail = name.removeprefix("netG_epoch_").removesuffix(".pth")
            if name.startswith("netG_epoch_") and name.endswith(".pth") and tail.isdigit():
                out.append(int(tail))
        return sorted(out)
