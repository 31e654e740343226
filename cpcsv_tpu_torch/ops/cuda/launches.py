"""Launch counts of the hand-written kernels that stay true under CUDA-graph
replay.

Each wrapper (`bn.py`, `dfn.py`) calls `count(counts, name)` where it
launches its kernel, `counts` being its module's `launches` dict. A CUDA
graph capture (`train/graphs.py`) records kernels without running them, so
while `recording()` is open the launches go into the capture's record
instead; every replay of the graph then adds that record once (`add`). The
record is process-wide, not per thread: autograd runs a CUDA backward on a
thread of its own, whose launches belong to the same capture.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

# name -> [the wrapper's counts dict, launches]: a capture's record
Record = dict[str, list]

_record: Optional[Record] = None  # the open capture's record, None outside one


def count(counts: dict[str, int], name: str) -> None:
    """One launch of kernel `name`: counted, or recorded while a capture is open."""
    if _record is None:
        counts[name] += 1
    else:
        _record.setdefault(name, [counts, 0])[1] += 1


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """While open, launches are recorded, not counted; yields the record."""
    global _record
    if _record is not None:
        raise RuntimeError("a launch record is already open: one CUDA graph captures at a time")
    _record = {}
    try:
        yield _record
    finally:
        _record = None


def add(record: Record) -> None:
    """Counts a record's launches once (one replay of its graph)."""
    for name, (counts, n) in record.items():
        counts[name] += n
