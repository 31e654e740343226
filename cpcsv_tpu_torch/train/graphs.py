"""CUDA graphs captured at a set of input shapes and replayed: the port's
counterpart of the JAX package's programs compiled per input shape. Two
callers share this core: the D+G pair of the trainer's chunks (the JAX
trainer's K updates in one `lax.scan` program, `train/steps.py:make_scan_steps`)
and eval-mode story generation (the JAX package's jitted samplers,
`evaluation/sampling.py`), which keeps its graphs in one shared memory pool.

A `ShapeGraph` holds a call's input buffers, the graph captured on them and
the outputs the graph writes, such as a pair's row of metrics. It is built
on a call's inputs, which it copies into buffers of its own; the caller runs
that call eagerly on the buffers (for a pair a real update, which also warms
cuDNN and the allocator) and then `capture`s it. Capture records the
kernels without running them, so it leaves the state as the eager call
left it. A `replay` copies the next call's inputs into the buffers device
to device and launches the graph: a constant amount of host work a call,
no host sync. `ShapeGraphs` keeps a caller's graphs by key, the least
recently used dropped.

What a replay of a pair must see is what an eager pair sees:

* the noise: the epoch's `torch.Generator` is registered with the graph,
  so every replay draws from its current state, as an eager pair would,
  and advances it by the pair's draws;
* the learning rates and Adam's step count: device tensors that the graph
  reads (`train/state.py:Adam`);
* BN running statistics, SN vectors, parameters and Adam moments: updated
  in place, never rebound, so the graph's writes land in the state;
* the kernels' launch counts: the capture's launches are recorded, not
  counted, and every replay adds them (`ops/cuda/launches.py`).

The pair's capture runs in the graph's private memory pool, under
`float32_math` as the eager pair, so it keeps the algorithms the eager pair
chose. Its mode is "thread_local": the batch prefetch thread pins host
memory and copies on a stream of its own while a pair captures, which the
"global" mode would count against the capture.

Every pair of the captured path, eager ones included, runs on one side
stream of its `ShapeGraphs` (`ShapeGraphs.stream`), and the capture too.
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

# graphs kept at once by the pair graphs: the batches' shapes and, where
# the loader's last batch is short, a ragged tail's; each holds a step's
# peak in its pool
MAX_GRAPHS = 2


def input_key(inputs) -> tuple:
    """The shapes and dtypes of a pytree's tensors, in its flattened order."""
    return tuple((tuple(t.shape), t.dtype) for t in tree_flatten(inputs)[0])


class ShapeGraph:
    """A call captured as a CUDA graph at one key (its inputs' shapes, and
    whatever else the caller's key holds): its input buffers, the graph and
    the outputs each replay writes."""

    def __init__(self, inputs, generator: Optional[torch.Generator], key: tuple):
        leaves, self._spec = tree_flatten(inputs)
        self._buffers = [t.clone() for t in leaves]
        self.key = key
        self.inputs = tree_unflatten(self._buffers, self._spec)  # the buffers, as `inputs`
        self.generator = generator
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None  # what each replay writes
        self.launches: launches.Record = {}  # the kernels' launches a replay makes

    def capture(self, call: Callable, pool=None) -> None:
        """Captures call(generator, self.inputs) -> outputs, in the memory
        pool `pool` (None: a private one). The graph is kept (`keep_graph`)
        so that its nodes can be counted."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with launches.recording() as record, torch.cuda.graph(
                graph, pool=pool, stream=torch.cuda.current_stream(),
                capture_error_mode="thread_local"):
            self.out = call(self.generator, self.inputs)
        graph.instantiate()
        self.graph, self.launches = graph, record

    def replay(self, inputs):
        """The call on `inputs` (of this graph's shapes): copied into the
        buffers, the graph replayed; returns the outputs it wrote, valid
        until the next replay."""
        torch._foreach_copy_(self._buffers, tree_flatten(inputs)[0])
        self.graph.replay()
        launches.add(self.launches)
        return self.out


class ShapeGraphs:
    """Captured graphs by key and generator, at most `max_graphs` (the least
    recently used goes). With `shared_pool` every capture shares one memory
    pool: right for graphs that never run at once, whose outputs are read
    before the next replay of any of them."""

    def __init__(self, max_graphs: int = MAX_GRAPHS, shared_pool: bool = False):
        self.graphs: dict[tuple, ShapeGraph] = {}
        self.max_graphs = max_graphs
        self._shared_pool = shared_pool
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    @property
    def pool(self):
        """The memory pool of the next capture: the shared one, or None."""
        if self._shared_pool and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    @contextlib.contextmanager
    def stream(self, device: torch.device) -> Iterator[torch.cuda.Stream]:
        """The side stream the calls and captures run on, current while the
        block runs: it waits for the current stream's work first, and the
        current stream waits for its work after."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield self._stream
        current.wait_stream(self._stream)

    def get(self, key: tuple, generator: Optional[torch.Generator]) -> Optional[ShapeGraph]:
        """The captured graph at `key` for this generator."""
        graph = self.graphs.get(key)
        if graph is None or graph.generator is not generator:
            return None
        self.graphs[key] = self.graphs.pop(key)  # most recently used last
        return graph

    def add(self, graph: ShapeGraph) -> None:
        """Keeps a captured graph, replacing any at its key."""
        self.graphs.pop(graph.key, None)
        while len(self.graphs) >= self.max_graphs:
            del self.graphs[next(iter(self.graphs))]
        self.graphs[graph.key] = graph
