"""Host-side data loader (counterpart of `cpcsv_tpu/data/loader.py`):
shuffling, batching, drop_last, and a background prefetch thread, in numpy.

It is not `torch.utils.data.DataLoader` on purpose: for a given (seed,
epoch) it draws the same batches in the same order as the JAX package's
loader, so a run of the port and one of the JAX package see the same data.
Items are dicts of numpy arrays, plus other fields (such as 'text') that are
collated into lists.

In a process group each rank reads its data shard, the contiguous 1/D slice
of every global batch at its index d on the mesh's `data` axis
(`parallel/mesh.py`; D = W, the world size, without other axes), as the JAX
package's per-host input pipeline does (`cpcsv_tpu/data/loader.py:31-61,86-112`),
index for index. The replicas of a shard (the ranks that differ only on the
other axes) read the same rows.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

from cpcsv_tpu_torch.data.prefetch import device_prefetch
from cpcsv_tpu_torch.parallel.distributed import process_info
from cpcsv_tpu_torch.parallel.mesh import mesh_layout, mesh_size

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
        """`batch_size` is the global batch. With process_count > 1 (the data
        shards, `training_loaders`), the process reads only
        shard process_index, its contiguous 1/process_count slice of every
        global batch.
        The shuffle stream derives from `seed` alone, never from the
        process, so every rank draws the same global permutation."""
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int) -> None:
        """The shuffle stream, and the dataset's per-item draws where it has
        them (`data/pororo.py:_SeededDraws`), from (seed, epoch), as torch's
        DistributedSampler.set_epoch: a resumed run's epoch E sees the data
        of an uninterrupted run's."""
        self._rng = np.random.default_rng([self._seed, epoch])
        draws = getattr(self.dataset, "_draws", None)
        if draws is not None:
            draws.reseed(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last or self.process_count > 1:
            # several processes: a partial global batch cannot be split
            # evenly, so it is dropped as drop_last would (every rank must
            # agree on the batch count)
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        for b in range(len(self)):
            batch = idx[b * self.batch_size : (b + 1) * self.batch_size]
            if self.process_count > 1:
                local = len(batch) // self.process_count
                lo = self.process_index * local
                batch = batch[lo : lo + local]
            yield batch

    def unsliced(self) -> "DataLoader":
        """This loader without the per-process slicing: full global batches
        from the shuffle stream of `seed`. The centralized walks
        (`evaluation/drivers.py`) run on rank 0 over it, the whole test set."""
        if self.process_count == 1:
            return self
        full = copy.copy(self)
        full.process_index, full.process_count = 0, 1
        full._rng = np.random.default_rng(self._seed)
        return full

    def __iter__(self) -> Iterator[dict]:
        # items are read and collated on a background thread, PREFETCH
        # batches ahead
        return device_prefetch(
            self._index_batches(),
            lambda idx: default_collate([self.dataset[int(i)] for i in idx]),
            depth=PREFETCH,
        )


def global_batches(cfg) -> tuple[int, int]:
    """(image, story) global batches: the config's per-rank batches times the
    mesh's ranks, the reference's batch × num_gpu (main_pororo.py:64)."""
    n = mesh_size(cfg.MESH_SHAPE)
    return cfg.TRAIN.IM_BATCH_SIZE * n, cfg.TRAIN.ST_BATCH_SIZE * n


def training_loaders(cfg, image, story, test, seed: int, shard=None):
    """(image, story, test) loaders at the global batches, shuffled from seed,
    + 1 and + 2 (the test loader in order), each reading data shard
    `shard` = (index, count) (`cpcsv_tpu/data/pororo.py:329-364`). None is
    this rank's shard of the training mesh cfg.MESH_SHAPE (`mesh_layout`,
    which raises for a mesh training refuses); the walks, which read the
    test set whole, pass (rank, world) and take any well-formed mesh."""
    im_bs, st_bs = global_batches(cfg)
    if shard is None:
        layout = mesh_layout(cfg.MESH_SHAPE, *process_info())
        shard = layout.data_index, layout.data_count
    pi, pc = shard
    kw = dict(drop_last=True, process_index=pi, process_count=pc)
    return (DataLoader(image, im_bs, shuffle=True, seed=seed, **kw),
            DataLoader(story, st_bs, shuffle=True, seed=seed + 1, **kw),
            DataLoader(test, st_bs, shuffle=False, seed=seed + 2, **kw))


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
