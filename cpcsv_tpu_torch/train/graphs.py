"""CUDA graphs of one D+G pair: the port's counterpart of the JAX trainer's
K updates in one `lax.scan` program (`train/steps.py:make_scan_steps`).

A `PairGraph` holds a pair's input buffers, the graph captured on them and
the row of metrics the graph writes. It is built on a pair's inputs, which
it copies into buffers of its own; the caller runs that pair eagerly on the
buffers (a real update, which also warms cuDNN and the allocator) and then
`capture`s it. Capture records the pair's kernels without running them, so
it leaves the state as the eager pair left it. A `replay` copies the next
pair's inputs into the buffers device to device and launches the graph: a
constant amount of host work a pair, no host sync.

What a replay must see is what an eager pair sees:

* the noise: the epoch's `torch.Generator` is registered with the graph,
  so every replay draws from its current state, as an eager pair would,
  and advances it by the pair's draws;
* the learning rates and Adam's step count: device tensors that the graph
  reads (`train/state.py:Adam`);
* BN running statistics, SN vectors, parameters and Adam moments: updated
  in place, never rebound, so the graph's writes land in the state;
* the kernels' launch counts: the capture's launches are recorded, not
  counted, and every replay adds them (`ops/cuda/launches.py`).

The capture runs in the graph's private memory pool, under `float32_math`
as the eager pair, so it keeps the algorithms the eager pair chose. Its
mode is "thread_local": the batch prefetch thread pins host memory and
copies on a stream of its own while a pair captures, which the "global"
mode would count against the capture.

Every pair of the captured path, eager ones included, runs on one side
stream of the `PairGraphs` (`PairGraphs.stream`), and the capture too.
Autograd keeps a parameter's gradient accumulator, with the stream it was
made on, as long as anything holds the parameter's autograd graph, and a
spectral-normed layer holds its last `weight` that way; a pair captured on
another stream than the one such an accumulator was made on would make the
capture wait on that stream, which a capture cannot do.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from cpcsv_tpu_torch.ops.cuda import launches

# graphs kept at once: the batches' shapes and, where the loader's last
# batch is short, a ragged tail's; each holds a step's peak in its pool
MAX_GRAPHS = 2


def _key(leaves: list[torch.Tensor]) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in leaves)


class PairGraph:
    """One D+G pair captured as a CUDA graph, at one set of input shapes."""

    def __init__(self, inputs, generator: Optional[torch.Generator]):
        leaves, self._spec = tree_flatten(inputs)
        self._buffers = [t.clone() for t in leaves]
        self.key = _key(leaves)
        self.inputs = tree_unflatten(self._buffers, self._spec)  # the buffers, as `inputs`
        self.generator = generator
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None  # the row each replay writes
        self.launches: launches.Record = {}  # the kernels' launches a replay makes

    def capture(self, pair: Callable, state) -> None:
        """Captures pair(state, generator, self.inputs) -> row. The graph is
        kept (`keep_graph`) so that its nodes can be counted."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with launches.recording() as record, torch.cuda.graph(
                graph, stream=torch.cuda.current_stream(), capture_error_mode="thread_local"):
            self.out = pair(state, self.generator, self.inputs)
        graph.instantiate()
        self.graph, self.launches = graph, record

    def replay(self, inputs) -> torch.Tensor:
        """The pair on `inputs` (of this graph's shapes): copied into the
        buffers, the graph replayed; returns the metrics row it wrote,
        valid until the next replay."""
        torch._foreach_copy_(self._buffers, tree_flatten(inputs)[0])
        self.graph.replay()
        launches.add(self.launches)
        return self.out


class PairGraphs:
    """The pair graphs of one `make_scan_steps`, by input shapes and
    generator, at most MAX_GRAPHS (the least recently used goes)."""

    def __init__(self):
        self.graphs: dict[tuple, PairGraph] = {}
        self._stream: Optional[torch.cuda.Stream] = None

    @contextlib.contextmanager
    def stream(self, device: torch.device) -> Iterator[torch.cuda.Stream]:
        """The side stream the pairs and captures run on, current while the
        block runs: it waits for the current stream's work first, and the
        current stream waits for its work after."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield self._stream
        current.wait_stream(self._stream)

    def get(self, inputs, generator: Optional[torch.Generator]) -> Optional[PairGraph]:
        """The captured graph for these inputs' shapes and this generator."""
        graph = self.graphs.get(_key(tree_flatten(inputs)[0]))
        if graph is None or graph.generator is not generator:
            return None
        self.graphs[graph.key] = self.graphs.pop(graph.key)  # most recently used last
        return graph

    def add(self, graph: PairGraph) -> None:
        """Keeps a captured graph, replacing any at its shapes."""
        self.graphs.pop(graph.key, None)
        while len(self.graphs) >= MAX_GRAPHS:
            del self.graphs[next(iter(self.graphs))]
        self.graphs[graph.key] = graph
