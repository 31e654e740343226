"""Eval-mode story generation, one dispatch a call on a card: the port's
counterpart of the JAX package's jitted samplers (`Infer._sampler`,
`cpcsv_tpu/evaluation/drivers.py:158-175`; the dataset's `_sample_videos_jit`,
`cpcsv_tpu/evaluation/datasets.py:81-90`; the trainer's epoch grid,
`cpcsv_tpu/train/trainer.py:404-425`), each a program compiled once per
input shape.

`sample(net_g, motion, content, seg, generator)` returns (video, mask or
None) of the generator's `sample_videos`, under `torch.no_grad` and
`float32_math`. Every caller goes through it: `Infer.sample_videos_np` (and
with it `generate_story`, `inference_samples`, `save_test_samples` and the
walks), `StoryGANDataset` (`eval_ssim`, the in-training FID/FSD), and the
trainer's epoch grid.

On a card the first call at a key runs eagerly and returns its result (which
also warms cuDNN and the allocator), then is captured as a CUDA graph
(`train/graphs.py`); every later call at that key copies its inputs into the
graph's buffers and replays it. The key is what the forward reads besides
the tensors' values: the inputs' shapes and dtypes, `seg`, the compute
dtype, every `UpBlock`'s `fused` lowering, the module's mode, cuDNN's
`deterministic` and `benchmark` flags, and the noise generator object, which
is registered with the graph, so a replay draws from its current state and
advances it as an eager call would (`manual_seed` and `set_state` reach the
replay). A flipped lowering is a new key, never a stale replay.

A net's graphs live with the net (`cache_of`, a weak reference to it), so
each epoch's hook and walk replays the graphs of the last; at most
MAX_GRAPHS, the least recently used dropped, all in one memory pool: they
never run at once. A graph reads the parameters and BN buffers in place,
which `load_state_dict` and the port's Adam update in place and never
rebind, so a graph captured on one snapshot replays right on the next. The
outputs of a replay are the graph's own tensors, valid until the next call
through the same net: callers copy them to the host first.

A capture that fails raises: no call drops to the eager path after one. On
the CPU every call runs eagerly.
"""

from __future__ import annotations

import collections
import functools
import weakref
from typing import Optional

import torch
import torch.nn as nn

from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.ops.blocks import UpBlock
from cpcsv_tpu_torch.train.graphs import ShapeGraph, ShapeGraphs, input_key

# graphs kept a net: a walk's batch and its ragged tail, with and without
# seg, or a lowering or two beside them
MAX_GRAPHS = 4


class SamplerCache:
    """The captured samplers of one net."""

    def __init__(self, net: nn.Module):
        self.graphs = ShapeGraphs(MAX_GRAPHS, shared_pool=True)
        self.upblocks = [m for m in net.modules() if isinstance(m, UpBlock)]


_caches: "weakref.WeakKeyDictionary[nn.Module, SamplerCache]" = weakref.WeakKeyDictionary()
# calls on a card, every net's: "eager" (a key's first), "captured", "replayed"
totals = collections.Counter()


def cache_of(net_g: nn.Module) -> SamplerCache:
    """The sampler cache of `net_g`, made at its first use."""
    cache = _caches.get(net_g)
    if cache is None:
        cache = _caches[net_g] = SamplerCache(net_g)
    return cache


def sample_key(net_g: nn.Module, motion: torch.Tensor, content: torch.Tensor, seg: bool,
               generator: Optional[torch.Generator]) -> tuple:
    """What a captured call depends on besides the values of its inputs and
    of the net's parameters and buffers."""
    return (input_key((motion, content)), bool(seg), net_g.dtype,
            tuple(b.fused for b in cache_of(net_g).upblocks), net_g.training,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            id(generator))  # the graph holds the generator, so its id stays its own


def _run(net_g: nn.Module, seg: bool, generator, inputs):
    out = net_g.sample_videos(*inputs, seg=seg, generator=generator)
    return out.image, out.seg


def sample(net_g: nn.Module, motion: torch.Tensor, content: torch.Tensor, seg: bool = False,
           generator: Optional[torch.Generator] = None):
    """motion (B, T, 365), content (B, T, 356) on the net's device -> (video
    (B, T, 64, 64, 3), mask (B*T, 64, 64, 1) or None) in the compute dtype,
    noise drawn from `generator`; captured and replayed on a card."""
    with torch.no_grad(), float32_math():
        if not motion.is_cuda:
            return _run(net_g, seg, generator, (motion, content))
        cache = cache_of(net_g)
        key = sample_key(net_g, motion, content, seg, generator)
        with cache.graphs.stream(motion.device):
            graph = cache.graphs.get(key, generator)
            if graph is not None:
                totals["replayed"] += 1
                return graph.replay((motion, content))
            graph = ShapeGraph((motion, content), generator, key)
            call = functools.partial(_run, net_g, seg)
            out = call(generator, graph.inputs)
            totals["eager"] += 1
            graph.capture(call, pool=cache.graphs.pool)
            cache.graphs.add(graph)
            totals["captured"] += 1
        current = torch.cuda.current_stream(motion.device)
        for t in out:  # made on the side stream, read on this one
            if t is not None:
                t.record_stream(current)
        return out
