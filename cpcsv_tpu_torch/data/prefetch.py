"""Background prefetch (counterpart of `cpcsv_tpu/data/prefetch.py`) and the
host-to-card copy of batches that overlaps the step before them.

`device_prefetch(iterable, put_fn, depth)` keeps `depth` items in flight:
each is `put_fn`-prepared on a background thread while the caller works on
earlier ones. `BatchCopier` is such a `put_fn` for a batch dict: on a CUDA
device it copies the arrays from pinned host memory with non-blocking copies
on a side stream and records an event; `ready` makes the consumer's stream
wait for that event before the step reads the batch. On the CPU it only
wraps the arrays as tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def device_prefetch(iterable: Iterable, put_fn: Callable, depth: int = 2) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()

    def producer():
        try:
            for item in iterable:
                q.put(put_fn(item))
        except Exception as e:
            q.put(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, Exception):
            raise item
        yield item


class BatchCopier:
    """Batch dicts (numpy arrays and other fields) -> (float32 tensors on
    `device`, the copies' event or None); other fields are dropped."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, batch: dict):
        arrays = {k: np.ascontiguousarray(v, dtype=np.float32)
                  for k, v in batch.items() if isinstance(v, np.ndarray)}
        if self.stream is None:
            return {k: torch.from_numpy(v) for k, v in arrays.items()}, None
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tensors = {k: torch.from_numpy(v).pin_memory().to(self.device, non_blocking=True)
                       for k, v in arrays.items()}
            event = torch.cuda.Event()
            event.record(self.stream)
        return tensors, event

    def ready(self, staged) -> dict:
        """The tensors of a `__call__` result, once the current stream has
        been ordered after their copies (and the allocator told that this
        stream uses them)."""
        tensors, event = staged
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in tensors.values():
                t.record_stream(stream)
        return tensors
