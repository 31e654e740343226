"""One command trains over every card of the host: the CLIs' launcher.

One JAX process drives all its local devices: with MESH_SHAPE "" its CLI
trains over every one of them at the batches times their count
(`cpcsv_tpu/parallel/mesh.py:27-39`, `cpcsv_tpu/cli/main_pororo.py:75-79`).
A port process drives one card, so the port's counterpart is one command
that starts one rank a card: `local_world` says how many, by the JAX rules
over the visible cards (`mesh.training_world`), and `run_ranks` runs the
same CLI with the same arguments in that many processes, each joining the
process group through the environment `distributed.maybe_initialize_from_env`
reads. Everything after that is the multi-process run as it was: the data
shards, rank-0 writes, checkpoints, resume, the walk barrier.

The ranks start with the `spawn` method, the parent making no CUDA context
(this module imports nothing heavy: a rank imports what its `main` needs),
and write their output to a file each; the parent echoes rank 0's as it
comes. It waits for every rank. When one exits non-zero, it kills the
others (which would wait out a collective their peer never joins), prints
that rank's last lines and exits with its code. Nothing falls back to one
process.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Sequence

POLL_S = 0.1  # how often the parent looks at its ranks
TAIL_BYTES = 8000  # of a failed rank's output, printed


def local_world(mesh_shape: str, device: str, training: bool) -> int:
    """The processes a CLI run takes: MESH_SHAPE's training world over the
    visible cards for a training run (no --eval_* flag, no --load_ckpt) on
    `device` "cuda" whose environment names no process group; else 1, this
    process (the walks and the dump span the cards from one process, a
    named card is one card, and a run in a process group is one rank). A
    mesh larger than the host raises."""
    import torch

    from cpcsv_tpu_torch.parallel.distributed import env_names_group
    from cpcsv_tpu_torch.parallel.mesh import training_world

    if not training or device != "cuda" or env_names_group():
        return 1
    return training_world(mesh_shape, torch.cuda.device_count())


def _rank(main: Callable, argv: list, env: dict, log: str) -> None:
    """A rank's process: its output to `log`, the group's variables set,
    then main(argv)."""
    fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    sys.stdout.reconfigure(line_buffering=True)  # the parent echoes rank 0's lines as they come
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


def run_ranks(main: Callable, argv: Sequence[str], world: int) -> None:
    """main(argv) in `world` processes, rank r on card r
    (CPCSV_COORDINATOR a `file://` rendezvous in a fresh temporary
    directory, CPCSV_NUM_PROCESSES, CPCSV_PROCESS_ID and LOCAL_RANK),
    `main` a module-level function (it is pickled by name). Returns once
    every rank has exited 0; raises SystemExit with the code of the first
    that did not (128 + N for a rank killed by signal N), the others
    killed."""
    ctx = multiprocessing.get_context("spawn")
    root = tempfile.mkdtemp(prefix="cpcsv_ranks_")
    logs = [os.path.join(root, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            env = {"CPCSV_COORDINATOR": f"file://{os.path.join(root, 'rendezvous')}",
                   "CPCSV_NUM_PROCESSES": str(world), "CPCSV_PROCESS_ID": str(r),
                   "LOCAL_RANK": str(r)}
            open(logs[r], "wb").close()
            procs.append(ctx.Process(target=_rank, args=(main, list(argv), env, logs[r]),
                                     name=f"rank{r}"))
            procs[-1].start()
        echoed, failed = 0, None
        while failed is None and any(p.exitcode is None for p in procs):
            time.sleep(POLL_S)
            echoed = _echo(logs[0], echoed)
            failed = next((r for r, p in enumerate(procs) if p.exitcode not in (None, 0)), None)
        _echo(logs[0], echoed)
        if failed is None:  # every rank has exited
            failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        if failed is not None:
            code = procs[failed].exitcode
            code = 128 - code if code < 0 else code
            for p in procs:
                if p.exitcode is None:
                    p.kill()
            with open(logs[failed], "rb") as f:
                f.seek(max(0, os.path.getsize(logs[failed]) - TAIL_BYTES))
                tail = f.read().decode(errors="replace")
            print(f"rank {failed} of {world} exited {code}; the others were stopped. Its last "
                  f"output:\n{tail}", file=sys.stderr, flush=True)
            raise SystemExit(code)
    finally:
        for p in procs:  # none outlives the command, whatever ended it
            if p.exitcode is None:
                p.kill()
            p.join()
        shutil.rmtree(root, ignore_errors=True)
