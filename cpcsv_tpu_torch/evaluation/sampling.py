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

Given an eval mesh (`parallel/mesh.py:make_eval_mesh`), a call is split into
`eval_shards` contiguous row blocks, one a device of the mesh, as the JAX
package's `shard_eval_inputs` lays a batch over P("data"). The noise of the
whole batch is drawn first, on the net's device from `generator`, in the
order one call draws it, and sliced by rows, so the frames and the
generator's state are those of the one-device call. Each block runs on a
replica of the net on its device (the net itself where the lead device is
its own), with a sampler cache of its own and its noise an input of its
graph. Every block's inputs are copied to its device, then every block is
launched, then the outputs are gathered to the net's device in row order,
so the devices overlap. A replica copies the net's parameters and buffers
in place whenever their version counters moved (`load_state_dict`,
`load_epoch`, any eager in-place write; not a CUDA graph's writes, which
only the trainer makes), so its graphs stay valid across snapshots; it
takes the net's mode and lowerings at every call. TORCH_REPEAT_QUIRK pairs each frame with another
sample's content (`models/generator.py:sample_videos`), a cross-sample op,
so a net with it runs unsharded.
"""

from __future__ import annotations

import collections
import copy
import functools
import weakref
from typing import Optional, Sequence

import torch
import torch.nn as nn

from cpcsv_tpu_torch.device import float32_math
from cpcsv_tpu_torch.ops.blocks import UpBlock
from cpcsv_tpu_torch.parallel.mesh import eval_shards
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
               generator: Optional[torch.Generator], noise: tuple = ()) -> tuple:
    """What a captured call depends on besides the values of its inputs and
    of the net's parameters and buffers."""
    return (input_key((motion, content, *noise)), bool(seg), net_g.dtype,
            tuple(b.fused for b in cache_of(net_g).upblocks), net_g.training,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            id(generator))  # the graph holds the generator, so its id stays its own


def _run(net_g: nn.Module, seg: bool, generator, inputs):
    motion, content, *noise = inputs
    out = net_g.sample_videos(motion, content, seg=seg, noise=tuple(noise) or None,
                              generator=generator)
    return out.image, out.seg


def _sample(net_g: nn.Module, inputs: tuple, seg: bool, generator):
    """One call on the net's device: eager on the CPU, captured and replayed
    on a card. `inputs` is (motion, content), or with the noise after them."""
    motion = inputs[0]
    if not motion.is_cuda:
        return _run(net_g, seg, generator, inputs)
    cache = cache_of(net_g)
    key = sample_key(net_g, *inputs[:2], seg, generator, inputs[2:])
    with torch.cuda.device(motion.device), cache.graphs.stream(motion.device):
        graph = cache.graphs.get(key, generator)
        if graph is not None:
            totals["replayed"] += 1
            return graph.replay(inputs)
        graph = ShapeGraph(inputs, generator, key)
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


class Replicas:
    """A net's replicas on an eval mesh's devices, kept equal to it."""

    def __init__(self, net_g: nn.Module):
        self.nets: dict[int, nn.Module] = {}  # the shard's index -> its replica
        self._tensors = [*net_g.parameters(), *net_g.buffers()]
        self._versions = None  # the net's version counters at the last copy

    def of(self, net_g: nn.Module, devices) -> list[nn.Module]:
        """The net for each device: the net itself where the first is its
        own, else a replica, made at its first use, holding the net's
        weights, mode and lowerings."""
        home = self._tensors[0].device
        versions = [t._version for t in self._tensors]
        stale = versions != self._versions
        nets = []
        for k, dev in enumerate(devices):
            if k == 0 and dev == home:
                nets.append(net_g)
                continue
            replica = self.nets.get(k)
            if replica is None or next(replica.parameters()).device != dev:
                replica = self.nets[k] = copy.deepcopy(net_g).to(dev)
            elif stale:
                for dst, src in zip([*replica.parameters(), *replica.buffers()], self._tensors):
                    dst.copy_(src, non_blocking=True)
            replica.train(net_g.training)
            for dst, src in zip(cache_of(replica).upblocks, cache_of(net_g).upblocks):
                dst.fused = src.fused
            nets.append(replica)
        self._versions = versions
        return nets


_replicas: "weakref.WeakKeyDictionary[nn.Module, Replicas]" = weakref.WeakKeyDictionary()


def replicas_of(net_g: nn.Module) -> Replicas:
    """The replicas of `net_g`, none made before its first sharded call."""
    reps = _replicas.get(net_g)
    if reps is None:
        reps = _replicas[net_g] = Replicas(net_g)
    return reps


def sample(net_g: nn.Module, motion: torch.Tensor, content: torch.Tensor, seg: bool = False,
           generator: Optional[torch.Generator] = None,
           mesh: Optional[Sequence[torch.device]] = None):
    """motion (B, T, 365), content (B, T, 356) on the net's device -> (video
    (B, T, 64, 64, 3), mask (B*T, 64, 64, 1) or None) on that device in the
    compute dtype, noise drawn from `generator`; captured and replayed on a
    card; split over the devices of `mesh` (`make_eval_mesh`) where `eval_shards` says so."""
    with torch.no_grad(), float32_math():
        shards = 1 if net_g.torch_repeat_quirk else eval_shards(mesh, motion.shape[0])
        if shards == 1:
            return _sample(net_g, (motion, content), seg, generator)
        B, T = motion.shape[:2]
        noise = net_g.draw_noise(B, T, generator)
        rows = B // shards
        nets = replicas_of(net_g).of(net_g, mesh)
        # every block's inputs on its device before any block runs: a copy
        # out of the lead's memory waits for the lead's stream, which waits
        # for the lead's block once that is launched
        blocks = [tuple(t[k * rows:(k + 1) * rows].to(dev, non_blocking=True)
                        for t in (motion, content, *noise))
                  for k, dev in enumerate(mesh)]
        outs = [_sample(net, inputs, seg, None) for net, inputs in zip(nets, blocks)]
        home = motion.device
        image = torch.cat([o[0].to(home) for o in outs])
        mask = None if outs[0][1] is None else torch.cat([o[1].to(home) for o in outs])
        return image, mask
