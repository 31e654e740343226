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

Ranks and hosts, as the JAX package counts them: its CPCSV_NUM_PROCESSES
counts processes, one a host, and CPCSV_PROCESS_ID is the host's index
(`cpcsv_tpu/parallel/distributed.py`). A port process with no LOCAL_RANK in
its environment is such a host, and where it joins the group itself (a
host of one rank) its rank is its host index. A process a launcher started
(`parallel/launch.py`, one rank a card of its host, or torchrun) has
LOCAL_RANK and LOCAL_WORLD_SIZE = L: its rank is host × L + LOCAL_RANK of
hosts × L, host-major, the JAX package's global device order. The ranks a
launcher starts (CPCSV_LAUNCHED=1) join the key-value store that the
launchers of every host opened at the coordinator (`open_store`; its
server in host 0's launcher), under a prefix of their own.
`host_info` gives a rank its (host, hosts, local rank, L).

Nothing here falls back to one process: a failed `init_process_group`, a
half-set environment or a world size that does not match the run raises.
"""

from __future__ import annotations

import datetime
import os
import urllib.parse
from typing import Optional

import torch
import torch.distributed as dist

from cpcsv_tpu_torch.parallel.launch import host_env

_host_group = None  # the gloo group of the host-side barriers, set at initialization
_data_groups = {}  # every partition of the ranks formed into data groups -> this rank's group
_data = None  # (group, index, count) of this rank's data group; None: the whole world
_host = (0, 1, 0, 1)  # (host, hosts, local rank, ranks a host) of this rank, set at initialization
LAUNCHED = "CPCSV_LAUNCHED"  # set on the ranks of `launch.run_ranks`: the store is its launchers'
RENDEZVOUS_S = 300.0  # seconds the hosts and ranks of a run wait for one another to join


def barrier_timeout() -> datetime.timedelta:
    """CPCSV_EVAL_BARRIER_MIN minutes (240 when unset), as the JAX package's
    walk barrier (`cpcsv_tpu/evaluation/drivers.py:45-58`)."""
    return datetime.timedelta(minutes=float(os.environ.get("CPCSV_EVAL_BARRIER_MIN", "240")))


def _init_method(address: str) -> str:
    """host:port -> tcp://host:port; a URL (tcp://, file://, env://) as it is."""
    return address if "://" in address else f"tcp://{address}"


def open_store(address: str, server: bool = False):
    """The key-value store at a coordinator address: host:port (or
    tcp://host:port) a TCPStore, its server in the process that passes
    `server`, the others its clients; file://PATH a FileStore on a shared
    filesystem (a fresh path a run). Joining waits up to RENDEZVOUS_S."""
    timeout = datetime.timedelta(seconds=RENDEZVOUS_S)
    url = urllib.parse.urlsplit(_init_method(address))
    if url.scheme == "tcp" and url.hostname and url.port:
        return dist.TCPStore(url.hostname, url.port, is_master=server, timeout=timeout,
                             wait_for_workers=False)
    if url.scheme == "file" and url.path:
        store = dist.FileStore(url.path, -1)
        store.set_timeout(timeout)
        return store
    raise ValueError(f"coordinator {address!r}: the hosts of a run meet at host:port, "
                     "tcp://host:port or file://PATH")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: str = "cuda",
    local_rank: Optional[int] = None,
    local_world: int = 1,
    launched: bool = False,
) -> None:
    """Join the process group (idempotent: a second call does nothing).
    `coordinator_address` is host:port or an init URL, `num_processes` the
    hosts and `process_id` this host's index; `local_rank` of `local_world`
    this rank's place among its host's ranks (None: the host is this one
    rank), so that the rank is process_id × local_world + local_rank of
    num_processes × local_world. `launched`: the launchers of the hosts
    serve the store at the coordinator (`open_store`), which this rank
    joins as a client. With none of the three, the launcher's environment
    (torchrun's MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, GROUP_RANK,
    LOCAL_RANK, LOCAL_WORLD_SIZE) is read. `backend` defaults to NCCL for
    a CUDA `device` and gloo for the CPU; a CUDA rank's current device
    becomes its local rank (`local_rank`, else LOCAL_RANK), or its rank
    modulo the visible cards, before the group forms."""
    global _host_group, _host
    if dist.is_initialized():
        return
    cuda = torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            raise ValueError("num_processes and process_id need a coordinator_address")
        init, kwargs = "env://", {}
        rank = int(os.environ["RANK"])
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        host = int(os.environ.get("GROUP_RANK", rank // per_host))
        hosts = int(os.environ["WORLD_SIZE"]) // per_host
        local = int(os.environ.get("LOCAL_RANK", rank % per_host))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        per_host = local_world if local_rank is not None else 1
        host, hosts, local = process_id, num_processes, local_rank or 0
        rank = host * per_host + local
        kwargs = dict(world_size=hosts * per_host, rank=rank)
        if launched:
            init = None
            kwargs["store"] = dist.PrefixStore("ranks", open_store(coordinator_address))
        else:
            init = _init_method(coordinator_address)
    if cuda:  # the local rank where a launcher set one, else the rank modulo the cards
        card = local_rank if local_rank is not None else os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(card) if card is not None else rank % torch.cuda.device_count())
        if backend == "nccl":  # the communicator forms now, on this card
            kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init, **kwargs)
    _host_group = dist.new_group(backend="gloo", timeout=barrier_timeout())
    _host = (host, hosts, local, per_host)


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


def maybe_initialize_from_env(backend: Optional[str] = None, device: str = "cuda") -> bool:
    """CLI hook: join the process group when the environment asks for it.
    Returns True if it did.

    Triggers (first match wins), the JAX package's variables:
      * CPCSV_COORDINATOR=host:port (or an init URL such as file:///path)
        with CPCSV_NUM_PROCESSES (the hosts) and CPCSV_PROCESS_ID (this
        host); one of the two missing raises. Without LOCAL_RANK this
        process is a host of one rank; with it (a launcher's rank, or one
        started by hand as torchrun starts them) LOCAL_WORLD_SIZE must be
        set too, and the rank is CPCSV_PROCESS_ID × LOCAL_WORLD_SIZE +
        LOCAL_RANK;
      * CPCSV_DISTRIBUTED=1: the launcher's environment (torchrun's RANK,
        WORLD_SIZE, MASTER_ADDR, MASTER_PORT, GROUP_RANK, LOCAL_RANK,
        LOCAL_WORLD_SIZE), the port's counterpart of the JAX package's
        TPU-pod auto-detection.
    """
    coord, hosts, host = host_env()
    if coord:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            initialize_distributed(coord, hosts, host, backend=backend, device=device)
            return True
        per_host = os.environ.get("LOCAL_WORLD_SIZE")
        if per_host is None:
            raise RuntimeError("LOCAL_RANK is set but LOCAL_WORLD_SIZE is missing: a rank of a "
                               "host needs its host's count of ranks")
        initialize_distributed(coord, hosts, host, backend=backend, device=device,
                               local_rank=int(local), local_world=int(per_host),
                               launched=os.environ.get(LAUNCHED) == "1")
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


def host_info() -> tuple[int, int, int, int]:
    """(host, hosts, this rank's index among its host's ranks, the ranks a
    host) as the group was joined; (0, 1, 0, 1) without a process group.
    The ranks of host h are h × L .. h × L + L − 1."""
    return _host if is_distributed() else (0, 1, 0, 1)


def host_group():
    """The gloo group of the host-side barriers (None without a group)."""
    return _host_group if is_distributed() else None


def destroy_distributed() -> None:
    """Leave the process group (tests and scripts that run several in turn)."""
    global _host_group, _data, _host
    if is_distributed():
        dist.destroy_process_group()
    _host_group, _data, _host = None, None, (0, 1, 0, 1)
    _data_groups.clear()
