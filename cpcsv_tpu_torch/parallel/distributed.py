"""The process group of a data-parallel run (counterpart of
`cpcsv_tpu/parallel/distributed.py`).

The JAX package runs one process per TPU host under `jax.distributed`; the
port runs one process per GPU in a `torch.distributed` process group: NCCL
when the run's device is CUDA, gloo on the CPU, unless the caller names a
backend. A process that never joins a group runs alone, exactly as before,
and issues no collective.

Besides the default group, every rank joins a gloo group of its own at
`initialize_distributed` (`host_group`): the barriers around checkpoint
writes and the centralized walks wait there, on the host, with a timeout of
CPCSV_EVAL_BARRIER_MIN minutes (240 when unset), since rank 0's walk can
take hours and NCCL's collectives would time out long before.

The collectives of a training step run over the rank's data group
(`parallel/mesh.py`). `form_data_groups` forms a mesh's data groups where
the training steps and the trainer first name the mesh
(`mesh.check_training_mesh`), every rank creating every group in the same
order (`dist.new_subgroups_by_enumeration`, which works under NCCL and
gloo), each partition once. A mesh whose one data group is the whole world
("", "data:W") keeps the default group and forms none. Before any mesh is
named the data group is the whole world.

Under NCCL every communicator forms before the first step, not at its
first collective: the default group's at `initialize_distributed` (bound to
the rank's card), a data group's where `form_data_groups` forms it (one
all-reduce of one element). A chunk's D+G pair is captured as a CUDA graph
with its all-reduces in it (`train/steps.py:make_scan_steps`), and a
communicator cannot form inside a capture.

Nothing here falls back to one process: a failed `init_process_group`, a
half-set environment or a world size that does not match the run raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

_host_group = None  # the gloo group of the host-side barriers, set at initialization
_data_groups = {}  # every partition of the ranks formed into data groups -> this rank's group
_data = None  # (group, index, count) of this rank's data group; None: the whole world


def barrier_timeout() -> datetime.timedelta:
    """CPCSV_EVAL_BARRIER_MIN minutes (240 when unset), as the JAX package's
    walk barrier (`cpcsv_tpu/evaluation/drivers.py:45-58`)."""
    return datetime.timedelta(minutes=float(os.environ.get("CPCSV_EVAL_BARRIER_MIN", "240")))


def _init_method(address: str) -> str:
    """host:port -> tcp://host:port; a URL (tcp://, file://, env://) as it is."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> None:
    """Join the process group (idempotent: a second call does nothing).
    `coordinator_address` is host:port or an init URL; with none of the
    three, the launcher's environment (torchrun's MASTER_ADDR, MASTER_PORT,
    RANK, WORLD_SIZE) is read. `backend` defaults to NCCL for a CUDA
    `device` and gloo for the CPU; a CUDA rank's current device becomes
    LOCAL_RANK, or its rank modulo the visible cards, before the group
    forms."""
    global _host_group
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes and process_id need a coordinator_address")
        init, kwargs = "env://", {}
        rank = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        init, kwargs = _init_method(coordinator_address), dict(world_size=num_processes,
                                                               rank=process_id)
        rank = process_id
    if cuda:  # LOCAL_RANK where the launcher sets it, else the rank modulo the cards
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None else rank % torch.cuda.device_count())
        if backend == "nccl":  # the communicator forms now, on this card
            kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init, **kwargs)
    _host_group = dist.new_group(backend="gloo", timeout=barrier_timeout())


def form_data_groups(groups) -> None:
    """Make `groups` (a partition of the ranks, each group in data order)
    the data groups of the collectives (`data_group`, `data_info`). The
    first call with a partition is collective: every rank makes it with the
    same groups in the same order. Later calls switch back to the groups
    already formed. One group of every rank, in rank order, is the default
    group: nothing is formed and the collectives stay on the whole world."""
    global _data
    groups = tuple(tuple(g) for g in groups)
    if groups == (tuple(range(dist.get_world_size())),):
        _data = None
        return
    if groups not in _data_groups:
        group = dist.new_subgroups_by_enumeration([list(g) for g in groups])[0]
        if dist.get_backend() == "nccl":  # its communicator forms here, outside any capture
            dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        _data_groups[groups] = group
    rank = dist.get_rank()
    mine = next(g for g in groups if rank in g)
    _data = (_data_groups[groups], mine.index(rank), len(mine))


def data_group():
    """The group of this rank's collectives: its data group, or None (the
    whole world) where that is the whole world, before a mesh is named or
    without a process group."""
    return _data[0] if _data is not None and is_distributed() else None


def data_info() -> tuple[int, int]:
    """(this rank's index in its data group, the group's size): the data
    shard a rank reads and the number of shards; (rank, world size) where
    the group is the whole world, (0, 1) without a process group."""
    if _data is None or not is_distributed():
        return process_info()
    return _data[1], _data[2]


def env_names_group() -> bool:
    """Whether the environment asks for a process group: CPCSV_COORDINATOR
    set, or CPCSV_DISTRIBUTED=1 (`maybe_initialize_from_env`'s triggers)."""
    return bool(os.environ.get("CPCSV_COORDINATOR")) or os.environ.get("CPCSV_DISTRIBUTED") == "1"


def maybe_initialize_from_env(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """CLI hook: join the process group when the environment asks for it.
    Returns True if it did.

    Triggers (first match wins), the JAX package's variables:
      * CPCSV_COORDINATOR=host:port (or an init URL such as file:///path)
        with CPCSV_NUM_PROCESSES and CPCSV_PROCESS_ID; one of the two
        missing raises;
      * CPCSV_DISTRIBUTED=1: the launcher's environment (torchrun's RANK,
        WORLD_SIZE, MASTER_ADDR, MASTER_PORT), the port's counterpart of
        the JAX package's TPU-pod auto-detection.
    """
    coord = os.environ.get("CPCSV_COORDINATOR")
    if coord:
        num = os.environ.get("CPCSV_NUM_PROCESSES")
        pid = os.environ.get("CPCSV_PROCESS_ID")
        if num is None or pid is None:
            raise RuntimeError(
                "CPCSV_COORDINATOR is set but "
                f"{'CPCSV_NUM_PROCESSES' if num is None else 'CPCSV_PROCESS_ID'}"
                " is missing: a half-configured multi-process environment")
        initialize_distributed(coord, int(num), int(pid), backend=backend, device=device)
        return True
    if os.environ.get("CPCSV_DISTRIBUTED") == "1":
        initialize_distributed(backend=backend, device=device)
        return True
    return False


def is_distributed() -> bool:
    """True inside a process group, of any size: the collectives run."""
    return dist.is_available() and dist.is_initialized()


def process_info() -> tuple[int, int]:
    """(rank, world size), (0, 1) without a process group."""
    if not is_distributed():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_group():
    """The gloo group of the host-side barriers (None without a group)."""
    return _host_group if is_distributed() else None


def destroy_distributed() -> None:
    """Leave the process group (tests and scripts that run several in turn)."""
    global _host_group, _data
    if is_distributed():
        dist.destroy_process_group()
    _host_group, _data = None, None
    _data_groups.clear()
