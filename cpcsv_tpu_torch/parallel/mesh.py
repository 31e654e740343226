"""Data parallelism over the process group (counterpart of
`cpcsv_tpu/parallel/mesh.py`).

The JAX package shards every batch over a one-axis device mesh and lets XLA
insert the collectives of one SPMD program over the global batch. The port
runs one process per GPU, each on its contiguous 1/W of the global batch
(W the world size), and states every collective the global program needs:
the BN sums (`ops/batchnorm.py`), the conditions of the wrong pairs and of
InfoNCE's pair matrix (`models/discriminators.py`), the loss counts and
metrics (`losses/gan_losses.py`, `train/steps.py`) and the gradients
(`train/steps.py:_step`). The contract is the JAX package's: a run on W
ranks equals a one-process run on the same global batches up to the order
of its reductions, since every loss is its rows' sum over the global count.

Every gather is a sum-all-reduce of a zero-padded buffer: gloo does only
`broadcast` and `all_reduce` on CUDA tensors, so the same code runs under
gloo on the CPU, under gloo with several ranks sharing one GPU, and under
NCCL. Without a process group nothing here issues a collective.

MESH_SHAPE is "" (every rank on the `data` axis) or "data:N". The JAX
package also takes other axes, over which it only replicates the forward;
training in the port refuses them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from cpcsv_tpu_torch.parallel.distributed import host_group, is_distributed, process_info

DATA_AXIS = "data"


def parse_mesh_shape(mesh_shape: str) -> list[tuple[str, int]]:
    """"data:4,model:2" -> [("data", 4), ("model", 2)]; "" -> []."""
    axes = []
    for item in filter(None, mesh_shape.split(",")):
        name, _, size = item.partition(":")
        if not name or not size.isdigit() or int(size) < 1:
            raise ValueError(f"MESH_SHAPE {mesh_shape!r}: each axis is NAME:SIZE, SIZE >= 1")
        axes.append((name.strip(), int(size)))
    return axes


def mesh_size(mesh_shape: str = "") -> int:
    """The ranks a mesh spans, the reference's `num_gpu` factor of the global
    batch (main_pororo.py:64): the world size for "", else the product of
    the axis sizes."""
    axes = parse_mesh_shape(mesh_shape)
    return math.prod(size for _, size in axes) if axes else process_info()[1]


def check_data_axes(mesh_shape: str) -> None:
    """NotImplementedError for a mesh with an axis other than `data`."""
    other = [name for name, _ in parse_mesh_shape(mesh_shape) if name != DATA_AXIS]
    if other:
        raise NotImplementedError(
            f"MESH_SHAPE {mesh_shape!r}: the port trains data-parallel only, on the "
            f"'{DATA_AXIS}' axis; the axes {other} (over which the JAX package replicates the "
            "forward) are not supported")


def check_training_mesh(mesh_shape: str) -> None:
    """A training run's mesh must span exactly the process group, as the JAX
    trainer's strict `make_mesh`: a mismatch would change the global batch."""
    check_data_axes(mesh_shape)
    world = process_info()[1]
    if mesh_size(mesh_shape) != world:
        raise ValueError(
            f"MESH_SHAPE {mesh_shape!r} spans {mesh_size(mesh_shape)} ranks but the run has "
            f"{world} process{'es' if world > 1 else ''}: launch one process a rank "
            "(CPCSV_COORDINATOR / CPCSV_NUM_PROCESSES / CPCSV_PROCESS_ID, or torchrun with "
            "CPCSV_DISTRIBUTED=1)")


class Rows(NamedTuple):
    """A rank's rows of a global batch: global rows lo .. lo + local of total."""

    lo: int
    local: int
    total: int


def batch_rows(local: int) -> Rows:
    """This rank's rows of a batch split evenly, `local` rows a rank."""
    rank, world = process_info()
    return Rows(rank * local, local, local * world)


def wrong_pair_rows(rows: Rows) -> Rows:
    """The wrong pairs (feature i, condition i + 1) of a global batch, i < B − 1,
    that fall to the rank of `rows`: the first B − 1 − lo of its rows at
    most, so the last rank has one fewer (none at one row a rank)."""
    local = max(0, min(rows.local, rows.total - 1 - rows.lo))
    return Rows(rows.lo, local, max(rows.total - 1, 0))


def all_reduce_sum_(buf: torch.Tensor) -> torch.Tensor:
    """In place, the sum of `buf` over the ranks (nothing without a group)."""
    if is_distributed():
        dist.all_reduce(buf)
    return buf


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (the same number of rows on each) stacked in rank
    order, as the sum-all-reduce of a zero buffer holding this rank's rows;
    `t` itself without a group. Takes no gradient."""
    if not is_distributed():
        return t
    lo, n, total = batch_rows(t.shape[0])
    buf = t.new_zeros((total, *t.shape[1:]))
    buf[lo:lo + n] = t.detach()
    dist.all_reduce(buf)
    return buf


def broadcast_from_rank0(obj):
    """Rank 0's `obj` on every rank, sent on the host (the gloo group of
    `distributed.host_group`, whose timeout lets the others wait out a long
    computation on rank 0); `obj` itself without a group."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def host_barrier() -> None:
    """Every rank waits here, on the host (the gloo group of
    `distributed.host_group`, CPCSV_EVAL_BARRIER_MIN's timeout); nothing
    without a group."""
    if is_distributed():
        dist.barrier(group=host_group())
