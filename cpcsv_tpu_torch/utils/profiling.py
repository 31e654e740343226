"""Tracing and step timers (counterpart of `cpcsv_tpu/utils/profiling.py`,
whose traces are jax.profiler's): `torch.profiler` traces and per-step
wall-clock timers.

Set CPCSV_PROFILE_DIR=/path and the trainer traces steps 2-5 of its first
epoch into that directory (`train/trainer.py`), a Chrome trace
(`*.pt.trace.json`) with the CPU ops and, on a card, the device kernels by
name, viewable in Perfetto or chrome://tracing.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def start_trace(log_dir: str) -> torch.profiler.profile:
    """A started torch.profiler session that writes its trace into `log_dir`
    when it stops."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=_activities(),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile) -> None:
    """Waits for the card's queued work, then stops `prof`, writing its trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def maybe_trace(log_dir: str | None):
    """A trace of the block into `log_dir`; nothing without one."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


class StepTimer:
    """Rolling per-step wall-clock stats after `warmup` steps; `stop` waits
    for the card's queued work first when given `sync_on` (a tensor or a
    device), as the JAX one blocks until its value is ready."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: list[float] = []
        self._t0 = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None):
        if sync_on is not None:
            device = sync_on.device if torch.is_tensor(sync_on) else torch.device(sync_on)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self._count += 1
        if self._count > self.warmup and self._t0 is not None:
            self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def frames_per_sec(self, frames_per_step: int) -> float:
        return frames_per_step / self.mean if self.times else float("nan")


def profile_env_dir() -> str | None:
    return os.environ.get("CPCSV_PROFILE_DIR") or None
