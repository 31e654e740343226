"""Data parallelism over the process group (counterpart of
`cpcsv_tpu/parallel/mesh.py`).

The JAX package shards every batch over the `data` axis of a device mesh
and lets XLA insert the collectives of one SPMD program over the global
batch. The port runs one process per GPU, each on its contiguous 1/D of the
global batch (D the size of the `data` axis: the world size W unless the
mesh has other axes), and states every collective the global program needs:
the BN sums (`ops/batchnorm.py`), the conditions of the wrong pairs and of
InfoNCE's pair matrix (`models/discriminators.py`), the loss counts and
metrics (`losses/gan_losses.py`, `train/steps.py`) and the gradients
(`train/steps.py:_step`). The contract is the JAX package's: a run on W
ranks equals a one-process run on the same global batches up to the order
of its reductions, since every loss is its rows' sum over the global count
(and bit for bit where D is 1).

Every gather is a sum-all-reduce of a zero-padded buffer: gloo does only
`broadcast` and `all_reduce` on CUDA tensors, so the same code runs under
gloo on the CPU, under gloo with several ranks sharing one GPU, and under
NCCL. Without a process group nothing here issues a collective.

MESH_SHAPE "a:n,b:m,..." lays the W = n·m·... ranks out as the JAX package
lays out its devices (`cpcsv_tpu/parallel/mesh.py:make_mesh`): rank r sits
at `np.unravel_index(r, (n, m, ...))`, the axes in MESH_SHAPE order, and ""
is every rank on `data`. A training mesh has a `data` axis: a rank reads
data shard d of D (d its coordinate on `data`, D that axis's size), every
other axis replicates, as the JAX trainer shards its batches over
P("data") and replicates its parameters. Each collective of a step runs
over the rank's data group, the D ranks that share all its other
coordinates (`distributed.form_data_groups`), so that the ranks of a group
compute the JAX program over the global batch and the groups repeat one
another bit for bit.

Eval-mode generation (serving, the walks, the in-training hook) runs in one
process over an eval mesh of that process's devices (`make_eval_mesh`), as
the JAX package's `make_eval_mesh` / `eval_shardings` / `shard_eval_inputs`
shard a generation call's batch over its local devices: `eval_shards` says
into how many contiguous row blocks a batch is split, one a device of
`make_eval_mesh`, by the JAX rules, and `evaluation/sampling.py` runs each
block on a replica of the generator there.
"""

from __future__ import annotations

import itertools
import math
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from cpcsv_tpu_torch.device import resolve_device
from cpcsv_tpu_torch.parallel.distributed import (
    data_group,
    data_info,
    form_data_groups,
    host_group,
    is_distributed,
    process_info,
)

DATA_AXIS = "data"


def parse_mesh_shape(mesh_shape: str) -> list[tuple[str, int]]:
    """"data:4,model:2" -> [("data", 4), ("model", 2)]; "" -> []. ValueError
    for a malformed axis or a name given twice (as `jax.sharding.Mesh`)."""
    axes = []
    for item in filter(None, mesh_shape.split(",")):
        name, _, size = item.partition(":")
        if not name or not size.isdigit() or int(size) < 1:
            raise ValueError(f"MESH_SHAPE {mesh_shape!r}: each axis is NAME:SIZE, SIZE >= 1")
        axes.append((name.strip(), int(size)))
    names = [name for name, _ in axes]
    if len(set(names)) != len(names):
        raise ValueError(f"MESH_SHAPE {mesh_shape!r}: an axis is named twice in {names}")
    return axes


def mesh_size(mesh_shape: str = "") -> int:
    """The ranks a mesh spans, the reference's `num_gpu` factor of the global
    batch (main_pororo.py:64): the world size for "", else the product of
    the axis sizes."""
    axes = parse_mesh_shape(mesh_shape)
    return math.prod(size for _, size in axes) if axes else process_info()[1]


class MeshLayout(NamedTuple):
    """Rank `rank`'s place in a training mesh: its coordinate on each axis,
    its data index and the data axis's size, and every data group (ranks in
    data order; the groups in C order of the other axes' coordinates)."""

    axes: tuple[tuple[str, int], ...]
    coords: tuple[int, ...]
    data_index: int
    data_count: int
    groups: tuple[tuple[int, ...], ...]


def mesh_layout(mesh_shape: str, rank: int, world: int) -> MeshLayout:
    """The layout of a training mesh over `world` ranks, as seen by `rank`.
    ValueError for a malformed mesh, one with no `data` axis (the JAX
    trainer's batches cannot be placed on P("data") there), or one that
    does not span the world (a strict `make_mesh`: another size would change
    the global batch)."""
    axes = tuple(parse_mesh_shape(mesh_shape)) or ((DATA_AXIS, world),)
    names, sizes = [n for n, _ in axes], [s for _, s in axes]
    if DATA_AXIS not in names:
        raise ValueError(f"MESH_SHAPE {mesh_shape!r} has no '{DATA_AXIS}' axis: training shards "
                         f"its batches over '{DATA_AXIS}'")
    if math.prod(sizes) != world:
        raise ValueError(
            f"MESH_SHAPE {mesh_shape!r} spans {math.prod(sizes)} ranks but the run has "
            f"{world} process{'es' if world > 1 else ''}: launch one process a rank "
            "(CPCSV_COORDINATOR / CPCSV_NUM_PROCESSES / CPCSV_PROCESS_ID, or torchrun with "
            "CPCSV_DISTRIBUTED=1)")
    k = names.index(DATA_AXIS)
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    others = [range(s) for i, s in enumerate(sizes) if i != k]
    groups = tuple(
        tuple(int(np.ravel_multi_index((*other[:k], d, *other[k:]), sizes))
              for d in range(sizes[k]))
        for other in itertools.product(*others))
    return MeshLayout(axes, coords, coords[k], sizes[k], groups)


def check_training_mesh(mesh_shape: str) -> MeshLayout:
    """This rank's layout of a training run's mesh (`mesh_layout`, which
    raises where the JAX trainer would refuse the mesh); in a process group
    its data groups become the collectives' (formed the first time a mesh is
    named: every rank calls this in the same order)."""
    layout = mesh_layout(mesh_shape, *process_info())
    if is_distributed():
        form_data_groups(layout.groups)
    return layout


class Rows(NamedTuple):
    """A rank's rows of a global batch: global rows lo .. lo + local of total."""

    lo: int
    local: int
    total: int


def batch_rows(local: int) -> Rows:
    """This rank's rows of a batch split evenly over the data axis, `local`
    rows a data shard: the replicas of a shard hold the same rows."""
    index, count = data_info()
    return Rows(index * local, local, local * count)


def wrong_pair_rows(rows: Rows) -> Rows:
    """The wrong pairs (feature i, condition i + 1) of a global batch, i < B − 1,
    that fall to the rank of `rows`: the first B − 1 − lo of its rows at
    most, so the last rank has one fewer (none at one row a rank)."""
    local = max(0, min(rows.local, rows.total - 1 - rows.lo))
    return Rows(rows.lo, local, max(rows.total - 1, 0))


def all_reduce_sum_(buf: torch.Tensor) -> torch.Tensor:
    """In place, the sum of `buf` over this rank's data group (nothing
    without a process group)."""
    if is_distributed():
        dist.all_reduce(buf, group=data_group())
    return buf


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The `t` of every rank of this rank's data group (the same number of
    rows on each) stacked in data order, as the sum-all-reduce of a zero
    buffer holding this rank's rows; `t` itself without a group. Takes no
    gradient."""
    if not is_distributed():
        return t
    lo, n, total = batch_rows(t.shape[0])
    buf = t.new_zeros((total, *t.shape[1:]))
    buf[lo:lo + n] = t.detach()
    dist.all_reduce(buf, group=data_group())
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


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices an eval mesh may span, as `jax.devices()` lists them:
    every card of the host for an index-less "cuda", else `device` alone
    (a named card, or the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_eval_mesh(mesh_shape: str = "", device: str | torch.device = "cuda",
                   devices: Optional[Sequence] = None) -> tuple[torch.device, ...]:
    """The devices one process generates on: the eval mesh of MESH_SHAPE over
    `devices` (default `local_devices(device)`; tests and chip_smoke.py name
    a list, a card or the CPU listed several times), one device a data index,
    in data order, the first the lead. "" is every device on `data`; a mesh
    larger than the list falls back to the list, with the JAX package's
    warning (walking a run trained on more cards than this host has); an
    axis other than `data` keeps its size, and a mesh without `data` has a
    data extent of 1. On a mesh with other axes (data:4,model:2) the JAX
    package runs each data shard on every device of its row, replicas that
    repeat the same rows; the port runs it once, on the row's first device
    (its other coordinates 0). Unlike the JAX
    package's, it never narrows to one device for USE_PALLAS: the DFN's CUDA
    kernel runs on every card, where a Mosaic call has no partitioning rule."""
    local = [torch.device(d) for d in devices] if devices is not None else local_devices(device)
    axes = parse_mesh_shape(mesh_shape)
    if axes and math.prod(size for _, size in axes) > len(local):
        warnings.warn(
            f"MESH_SHAPE {mesh_shape!r} needs {mesh_size(mesh_shape)} devices "
            f"but only {len(local)} are visible — eval falls back to "
            "the local device set (numerically identical, just less parallel).")
        axes = []
    axes = tuple(axes) or ((DATA_AXIS, len(local)),)
    names, sizes = [n for n, _ in axes], [s for _, s in axes]
    grid = np.arange(math.prod(sizes)).reshape(sizes)
    if DATA_AXIS in names:
        k = names.index(DATA_AXIS)
        rows = grid[tuple(slice(None) if i == k else 0 for i in range(len(sizes)))]
    else:
        rows = grid.reshape(-1)[:1]
    return tuple(local[int(i)] for i in rows)


def eval_shards(mesh: Optional[Sequence[torch.device]], batch: int) -> int:
    """Into how many row blocks a generation call of `batch` stories is split
    (`cpcsv_tpu/parallel/mesh.py:eval_shardings`): the data extent where it
    is above 1 and divides the batch, outside a process group of several
    ranks (whose walks run on rank 0, over its own card); else 1, unsharded.
    A ragged batch is no error: a walk's last batch often is."""
    if mesh is None or process_info()[1] > 1:
        return 1
    data = len(mesh)
    return data if data > 1 and batch % data == 0 else 1
