"""One command a host trains over every card of every host: the CLIs' launcher.

One JAX process drives all the local devices of its host, and one process
runs a host: CPCSV_COORDINATOR, CPCSV_NUM_PROCESSES (the hosts) and
CPCSV_PROCESS_ID (this host) start `jax.distributed`, and with MESH_SHAPE
"" the CLI trains over every device of every host at the batches times
their count (`cpcsv_tpu/parallel/mesh.py:27-39`,
`cpcsv_tpu/cli/main_pororo.py:57,75-79`). A port process drives one card,
so the port's counterpart is one command a host that starts one rank a
card: `local_world` says how many, by the JAX rules over the hosts' cards
(`mesh.training_world`), and `run_ranks` runs the same CLI with the same
arguments in that many processes, rank host × L + l on the host's card l,
each joining the process group through the environment
`distributed.maybe_initialize_from_env` reads. Everything after that is
the multi-process run as it was: the data shards, rank-0 writes,
checkpoints, resume, the walk barrier.

The launchers of a run of several hosts meet in a key-value store at the
coordinator (`distributed.open_store`: host 0's launcher serves a TCPStore
at host:port, or all share a FileStore at file://PATH). There each says
how many ranks it starts; hosts that differ raise on every host, and a
host that does not come within `distributed.RENDEZVOUS_S` seconds fails
the rendezvous. The ranks then form their group in the same store. The
ranks of one host form theirs at the coordinator alone (without one, a
`file://` rendezvous in a fresh temporary directory).

The ranks start with the `spawn` method, the parent making no CUDA context
(this module imports nothing heavy: a rank imports what its `main` needs),
and write their output to a file each; the parent echoes its first rank's
as it comes. It waits for every rank. When one exits non-zero, it kills the
others (which would wait out a collective their peer never joins), says so
in the store, prints that rank's last lines and exits with its code; the
launchers of the other hosts poll the store as they poll their own ranks,
and on that word, or once the store is gone, kill their ranks and exit
with the same code. Host 0's launcher, which serves the store, stays until
every host's ranks have ended. Nothing falls back to fewer hosts or ranks.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

POLL_S = 0.1  # how often the parent looks at its ranks and at the other hosts
TAIL_BYTES = 8000  # of a failed rank's output, printed
DONE_WAIT_S = 120.0  # how long host 0's launcher keeps the store for the other hosts' ranks
FAILED = "failed"  # the store's key of a run's first failure: "code|message"


def is_rank_env() -> bool:
    """Whether a launcher started this process as one rank of its host:
    LOCAL_RANK set (the port's launcher, torchrun, or a rank started by
    hand as they start them), or CPCSV_DISTRIBUTED=1 (torchrun)."""
    return "LOCAL_RANK" in os.environ or os.environ.get("CPCSV_DISTRIBUTED") == "1"


def host_env() -> tuple[Optional[str], int, int]:
    """(CPCSV_COORDINATOR, CPCSV_NUM_PROCESSES, CPCSV_PROCESS_ID): the
    coordinator, the hosts and this host's index; (None, 1, 0) where no
    coordinator is set. A coordinator without the other two raises."""
    coord = os.environ.get("CPCSV_COORDINATOR")
    if not coord:
        return None, 1, 0
    num = os.environ.get("CPCSV_NUM_PROCESSES")
    pid = os.environ.get("CPCSV_PROCESS_ID")
    if num is None or pid is None:
        raise RuntimeError(
            "CPCSV_COORDINATOR is set but "
            f"{'CPCSV_NUM_PROCESSES' if num is None else 'CPCSV_PROCESS_ID'}"
            " is missing: a half-configured multi-process environment")
    return coord, int(num), int(pid)


def local_world(mesh_shape: str, device: str, training: bool) -> int:
    """The processes a CLI run takes on this host: for a training run (no
    --eval_* flag, no --load_ckpt) on `device` "cuda" that is a host (no
    LOCAL_RANK, no CPCSV_DISTRIBUTED=1 in its environment), MESH_SHAPE's
    training world over its hosts' visible cards divided by the hosts;
    else 1, this process (the walks and the dump span the cards of one
    process, a named card is one card, and a launcher's rank is one rank).
    A mesh that the hosts' cards cannot hold raises; across hosts (a
    CPCSV_COORDINATOR) so does a named mesh that leaves cards out."""
    import torch

    from cpcsv_tpu_torch.parallel.mesh import training_world

    if not training or device != "cuda" or is_rank_env():
        return 1
    coord, hosts, _ = host_env()
    cards = torch.cuda.device_count()
    return training_world(mesh_shape, cards, hosts, every_card=coord is not None) // hosts


def _rank(main: Callable, argv: list, env: dict, log: str) -> None:
    """A rank's process: its output to `log`, the group's variables set,
    then main(argv)."""
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    sys.stdout.reconfigure(line_buffering=True)  # the parent echoes its first rank's lines
    os.environ.update(env)
    main(argv)


def _echo(path: str, at: int) -> int:
    """Writes what `path` gained past byte `at` to this process's stdout;
    returns the new end."""
    with open(path, "rb") as f:
        f.seek(at)
        new = f.read()
    if new:
        sys.stdout.buffer.write(new)
        sys.stdout.flush()
    return at + len(new)


def meet(store, host: int, hosts: int, ranks: int, timeout: float) -> None:
    """The launchers' rendezvous: this host says it starts `ranks` ranks and
    waits up to `timeout` seconds for every host to say as much. A host
    missing raises RuntimeError; hosts that start different numbers raise
    ValueError, naming each host's count (every host reads them all, so
    every host raises)."""
    import datetime

    store.set(f"ranks/{host}", str(ranks))
    keys = [f"ranks/{h}" for h in range(hosts)]
    try:
        store.wait(keys, datetime.timedelta(seconds=timeout))
    except Exception as e:  # the store's timeout error
        missing = [h for h in range(hosts) if not store.check([f"ranks/{h}"])]
        raise RuntimeError(f"rendezvous failed: host(s) {missing} of {hosts} did not join "
                           f"within {timeout:g} s") from e
    counts = [int(store.get(k)) for k in keys]
    if len(set(counts)) > 1:
        raise ValueError("every host of a run must see the same number of cards: "
                         + ", ".join(f"host {h} starts {c} rank(s)" for h, c in enumerate(counts)))


def _peer_failure(store):
    """(code, message) of a failure another host put in the store, or of
    the store itself gone (its server, host 0's launcher, ended); None."""
    try:
        if not store.check([FAILED]):
            return None
        code, _, message = store.get(FAILED).decode().partition("|")
        return int(code), message
    except Exception as e:
        return 1, f"the run's rendezvous store is gone ({type(e).__name__}: {e})"


def _meet_hosts(coord: str, host: int, hosts: int, world: int):
    """This host's launcher at the run's store (`distributed.open_store`,
    its server here on host 0), met with the other hosts' (`meet`); returns
    the store and what tells the ranks to join it."""
    import torch.distributed as dist

    from cpcsv_tpu_torch.parallel.distributed import LAUNCHED, RENDEZVOUS_S, open_store

    store = dist.PrefixStore("launch", open_store(coord, server=host == 0))
    meet(store, host, hosts, world, RENDEZVOUS_S)
    return store, {LAUNCHED: "1"}


def run_ranks(main: Callable, argv: Sequence[str], world: int) -> None:
    """main(argv) in `world` processes, this host's ranks, rank host × world
    + l on card l, `main` a module-level function (it is pickled by name).
    The host is the environment's (`host_env`; none: one host, a file://
    rendezvous in a fresh temporary directory); each rank gets those,
    LOCAL_RANK, LOCAL_WORLD_SIZE and, across hosts, CPCSV_LAUNCHED=1.
    Returns once every rank of every host has exited 0; raises SystemExit
    with the code of the first that did not (128 + N for a rank killed by
    signal N), this host's ranks killed."""
    coord, hosts, host = host_env()
    root = tempfile.mkdtemp(prefix="cpcsv_ranks_")
    coord = coord or f"file://{os.path.join(root, 'rendezvous')}"
    total = hosts * world
    ctx = multiprocessing.get_context("spawn")
    logs = [os.path.join(root, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        # one host: its ranks form their group at the coordinator themselves
        # (rank 0 serves a TCPStore); several: the launchers meet first
        store, extra = (_meet_hosts(coord, host, hosts, world) if hosts > 1 else (None, {}))
        for r in range(world):
            env = {"CPCSV_COORDINATOR": coord, "CPCSV_NUM_PROCESSES": str(hosts),
                   "CPCSV_PROCESS_ID": str(host), "LOCAL_RANK": str(r),
                   "LOCAL_WORLD_SIZE": str(world), **extra}
            open(logs[r], "wb").close()
            procs.append(ctx.Process(target=_rank, args=(main, list(argv), env, logs[r]),
                                     name=f"rank{host * world + r}"))
            procs[-1].start()
        echoed, failed, peer = 0, None, None
        while failed is None and peer is None and any(p.exitcode is None for p in procs):
            time.sleep(POLL_S)
            echoed = _echo(logs[0], echoed)
            failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
            if failed is None and hosts > 1:
                peer = _peer_failure(store)
        _echo(logs[0], echoed)
        if failed is None and peer is None:  # every rank of this host has exited
            failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        if failed is not None:
            code = procs[failed].exitcode
            code = 128 - code if code < 0 else code
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            said = f"rank {host * world + failed} of {total} exited {code}"
            if hosts > 1:
                try:
                    store.set(FAILED, f"{code}|{said} on host {host}")
                except Exception:  # the store is gone already: the others see that
                    pass
            with open(logs[failed], "rb") as f:
                f.seek(max(0, os.path.getsize(logs[failed]) - TAIL_BYTES))
                tail = f.read().decode(errors="replace")
            print(f"{said}; the others were stopped. Its last output:\n{tail}",
                  file=sys.stderr, flush=True)
            raise SystemExit(code)
        if peer is None and hosts > 1:
            store.set(f"done/{host}", "1")
            deadline = time.monotonic() + DONE_WAIT_S
            while host == 0 and time.monotonic() < deadline and peer is None and not all(
                    store.check([f"done/{h}"]) for h in range(hosts)):
                time.sleep(POLL_S)  # the store's server stays up for the other hosts
                peer = _peer_failure(store)
        if peer is not None:
            code, message = peer
            print(f"host {host} of {hosts}: {message}; this host's {world} rank(s) were stopped",
                  file=sys.stderr, flush=True)
            raise SystemExit(code)
    finally:
        for p in procs:  # none outlives the command, whatever ended it
            if p.exitcode is None:
                p.kill()
            p.join()
        shutil.rmtree(root, ignore_errors=True)
