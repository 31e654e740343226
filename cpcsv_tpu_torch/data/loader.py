"""Host-side data loader (counterpart of `cpcsv_tpu/data/loader.py`):
shuffling, batching, drop_last, and a background prefetch thread, in numpy.

It is not `torch.utils.data.DataLoader` on purpose: for a given (seed,
epoch) it draws the same batches in the same order as the JAX package's
loader, so a run of the port and one of the JAX package see the same data.
Items are dicts of numpy arrays, plus other fields (such as 'text') that are
collated into lists.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Sequence

import numpy as np

from cpcsv_tpu_torch.data.prefetch import device_prefetch

PREFETCH = 2  # batches a loader's background thread keeps ready


def default_collate(items: Sequence[Mapping[str, Any]]) -> dict:
    batch: dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals, axis=0)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals  # e.g. raw text strings
    return batch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """`batch_size` is the global batch. `process_index` / `process_count`
        keep the JAX package's signature for the multi-process slice; the
        port runs one process and raises on anything else."""
        if (process_index, process_count) != (0, 1):
            raise NotImplementedError(
                f"process {process_index} of {process_count}: the port's loader runs in "
                "one process; per-process slices come with the DDP slice")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """The shuffle stream from (seed, epoch), as torch's
        DistributedSampler.set_epoch: a resumed run's epoch E sees the data
        order of an uninterrupted run's."""
        self._rng = np.random.default_rng([self._seed, epoch])

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        # items are read and collated on a background thread, PREFETCH
        # batches ahead
        return device_prefetch(
            self._index_batches(),
            lambda idx: default_collate([self.dataset[int(i)] for i in idx]),
            depth=PREFETCH,
        )


class WrapAroundIterator:
    """Endless iterator over a loader (reference sample_real_image_batch,
    trainer.py:143-158: the image loader is drained in lockstep with the
    story loader and restarted when exhausted)."""

    def __init__(self, loader: DataLoader):
        if len(loader) == 0:
            raise ValueError(
                "loader yields no batches: dataset smaller than one batch "
                f"(len(dataset)={len(loader.dataset)}, batch={loader.batch_size})"
            )
        self.loader = loader
        self._it = iter(loader)

    def __next__(self) -> dict:
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)
