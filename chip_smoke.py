#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpcsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout with nvcc
     into build/kernels/ (one nvcc per source, all started together), with
     their register lines;
  3. the DFN kernels, forward and backward, against their plain PyTorch
     versions on the card: every instantiation, B in KERNEL_BATCHES, rows
     aligned and one element off, the backward on a row-strided dout, two
     launches giving the same bits;
  4. story generation at full width, configs final.yml (v1) and cascade.yml,
     through the serving entry point `Infer` with random weights from --seed:
     shapes, finite values in [-1, 1], the kernels' launch counts, the same
     frames through the plain DFN, float32 inside the entry point while
     TF32 is allowed globally, and a `generate_story` PNG walk;
  5. serving timings: frames/s and device busy time from a torch.profiler
     trace; the card's launch floor (an empty kernel in one CUDA graph); the
     DFN forward kernel at B = 90, 360 and 1440 in one CUDA graph and from a
     trace, over the floor, beside its bound, its plain version and a
     library call;
  6. training at full width, final.yml at IM_BATCH 90 / ST_BATCH 18, from
     `create_train_state` through `make_train_steps`: 2 warm-up and 5 timed
     D+G steps with finite metrics, every parameter, BN running statistic
     and SN u moved, each kernel's launches equal to the per-step count
     derived from the code times the steps, the BN calls of one step counted
     by shape, the DFN backward handed the row-strided dout of zmc_all's
     gradient with no copy, float32 inside the steps; ms per step, steps/s,
     device busy time and idle share from a trace, peak memory;
  7. from one saved state and the same noise, one D+G step with the kernels
     against one with their plain versions swapped in: losses, gradients and
     BN running statistics;
  8. the BN kernels against their plain versions at every (N, C, S) the
     step gave them, at N=7 and at edge shapes, each aligned and unaligned;
  9. the BN kernels and their library calls at every shape of the step, one
     CUDA graph each with L2-cold inputs, beside their bounds, summed over a
     step by launches; the plain versions and a trace at the largest shape;
     the DFN backward at B = 90 and 7 (and the op the step runs, on its
     strided dout) over the floor, and the DFN pair's time a step.
The line before the last is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
STORY_SIZES = (18, 72)  # stories per call; 5 frames each
KERNEL_BATCHES = (1, 7, 90, 360, 1440)
# (K, pad): the generator's taps and K=7 (the compile-time instantiations
# of csrc/dfn.cu, with C=3), K=5 (its runtime-K kernel), and L_out != L
TAPS = ((21, 10), (7, 3), (5, 2), (21, 0))
DFN_SHAPE = (3, 124, 21, 10)  # (C, L, K, pad) of the generator's DFN
DFN_STEP_LAUNCHES = {"dfn_forward": 4, "dfn_backward": 2}  # per D+G step
# the columns of the generator's zmc_all (zm_code, c_mu, DFN output): the G
# step's DFN dout is its last 124 columns, rows ZMC_WIDTH floats apart
ZMC_WIDTH = 613
LR_D, LR_G = 4e-4, 1e-4  # final.yml's DISCRIMINATOR_LR, GENERATOR_LR
WARMUP_STEPS, TIMED_STEPS = 2, 5
COLD_BYTES = 2**26  # 67 MB, more than the H100's 50 MB L2
GRAPH_REPLAYS = 5  # graph_ms' replays, of which it takes the median
# (N, C, S) beside the step's BN shapes: one row, one channel, S not a
# multiple of 4, short odd maps, and the dense heads' widths (S = 1)
EDGE_BN_SHAPES = ((1, 64, 4096), (90, 1, 1024), (7, 37, 5), (3, 5, 18), (2, 3, 2),
                  (90, 32768, 1), (18, 16384, 1), (90, 9, 1), (1, 1, 1))


T0 = time.perf_counter()


def phase(title: str) -> None:
    print(f"== {title} [t={time.perf_counter() - T0:.1f} s]", flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def _reps(fn, budget_s: float = 0.25, most: int = 200) -> int:
    """How many calls of `fn` fit in `budget_s`, from one synchronised call,
    between 3 and `most`: some library calls cost milliseconds of host time."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(3, min(most, int(budget_s / max(time.perf_counter() - t, 1e-6))))


def event_ms(fn) -> float:
    """Mean milliseconds per call of back-to-back calls, CUDA events."""
    import torch

    reps = _reps(fn)
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


HOST_WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMalloc", "cudaFree", "cudaMemcpy")  # runtime calls that stall the host


def trace(fn, reps: int):
    """(device events, host runtime events) of `reps` calls of `fn` under
    torch.profiler. Device events are the card's kernels, copies and sets,
    with their CUDA durations; host gaps between them are not in them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # now and then a trace records no device event at all
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        if dev:
            break
    check(bool(dev), "torch.profiler recorded no device activity in 3 traces")
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    return dev, host


def by_name(events, reps: int) -> dict[str, float]:
    """Microseconds per call by event name, largest first."""
    sums: dict[str, float] = {}
    for e in events:
        sums[e.name] = sums.get(e.name, 0.0) + e.time_range.elapsed_us() / reps
    return dict(sorted(sums.items(), key=lambda kv: -kv[1]))


def device_ms(fn, label: str) -> float:
    """Mean device milliseconds per call from a torch.profiler trace: the
    summed durations of the card's work, so host overhead and host waits
    between launches are excluded. Prints what the card ran per call and the
    host runtime calls that wait or allocate."""
    reps = _reps(fn, most=50)
    for _ in range(3):
        fn()
    dev, host = trace(fn, reps)
    names = by_name(dev, reps)
    waits = {k: sum(1 for e in host if e.name == k) / reps for k in HOST_WAITS}
    span = (max(e.time_range.end for e in dev) - min(e.time_range.start for e in dev)) / reps
    print(f"  {label}: per call {len(dev) / reps:.1f} device ops in a span of {span:.2f} us "
          + ", ".join(f"{k[:60]} {v:.2f} us" for k, v in list(names.items())[:3])
          + "; host waits/allocs per call "
          + (", ".join(f"{k} {v:g}" for k, v in waits.items() if v) or "none"))
    return sum(names.values()) / 1e3


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds per call of `reps` calls captured in one CUDA graph,
    the median of GRAPH_REPLAYS replays (one replay now and then runs several
    times slower): no host work between launches and no profiler. The DFN's
    library call, a grouped cuDNN conv1d, is timed so at B=90 only: it hung
    in capture at B >= 360."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[GRAPH_REPLAYS // 2] / reps


# one BN kernel at one (N, C, S) of the step: launches a step, and ms per
# call of the kernel and its library call in one CUDA graph, beside the bound
BnTime = collections.namedtuple("BnTime", "shape calls kernel_ms library_ms bound_ms")


def cold_graph_ms(fn, inputs: list) -> float:
    """Mean milliseconds per call of fn(*inputs[i % len(inputs)]), i = 0, 1,
    ..., in one CUDA graph (`graph_ms`), at least 20 calls and a whole
    number of rounds. The caller passes enough copies that together they
    exceed COLD_BYTES, so every call reads inputs that left the L2 since
    their last use, as a step's BN input that a large conv wrote long ago."""
    i = [0]

    def call():
        args = inputs[i[0] % len(inputs)]
        i[0] += 1
        return fn(*args)

    return graph_ms(call, len(inputs) * -(-20 // len(inputs)))


def cold_copies(gen, N: int, C: int, S: int, count: int, offset: int = 0) -> list:
    """`count` distinct float32 (N, C, S) tensors from one allocation, each
    starting 256-byte aligned plus `offset` elements."""
    import torch

    numel = N * C * S
    row = -(-(numel + offset) // 64) * 64
    buf = torch.randn(count, row, generator=gen, device="cuda")
    return [buf[k, offset:offset + numel].view(N, C, S) for k in range(count)]


def bn_cold_inputs(gen, name: str, N: int, C: int, S: int) -> list:
    """Argument tuples of BN kernel `name` at (N, C, S) for `cold_graph_ms`:
    at least 2 distinct copies, together more than COLD_BYTES; the copies of
    bn_grad_reduce share one mean and invstd ([C], a few KB)."""
    import torch

    tensors = 1 if name == "bn_stats" else 2
    copies = max(2, -(-COLD_BYTES // (4 * N * C * S * tensors)))
    views = cold_copies(gen, N, C, S, copies * tensors)
    if name == "bn_stats":
        return [(v,) for v in views]
    mean = views[0].mean(dim=(0, 2))
    inv = torch.rsqrt(views[0].var(dim=(0, 2), correction=0) + 1e-5)
    return [(views[2 * k], views[2 * k + 1], mean, inv) for k in range(copies)]


@contextlib.contextmanager
def counting_bn_calls():
    """While open, the BN wrappers count their calls by shape, passing each
    on: yields {kernel: {(N, C, S): calls}}."""
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    calls = {"bn_stats": {}, "bn_grad_reduce": {}}

    def counting(name: str):
        wrapped = getattr(bn_cuda, name)

        def call(x, *rest):
            shape = tuple(x.shape)
            calls[name][shape] = calls[name].get(shape, 0) + 1
            return wrapped(x, *rest)

        return mock.patch.object(bn_cuda, name, call)

    with counting("bn_stats"), counting("bn_grad_reduce"):
        yield calls


def dfn_bound(B: int, C: int, L: int, K: int, pad: int, itemsize: int):
    """(bound_ms, bound_by): the least time for the DFN's work on an H100,
    each input read once and the output written once, against the
    float32 multiply-adds over the non-tensor-core peak."""
    L_out = L + 2 * pad - K + 1
    nbytes = B * (C * L + C * K + L_out) * itemsize
    flops = 2 * B * L_out * C * K
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dfn_backward_bound(B: int, C: int, L: int, K: int, pad: int):
    """(bound_ms, bound_by) of the DFN backward: image, filters and dout read
    once, d image and d filters written once, against its multiply-adds."""
    L_out = L + 2 * pad - K + 1
    nbytes = B * (2 * C * L + 2 * C * K + L_out) * 4
    flops = 2 * B * C * K * (L_out + L)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_floor_ms() -> float:
    """The card's cost of one launch: `graph_ms` of torch.cuda._sleep(0),
    PyTorch's spin kernel (one thread) told to spin for 0 cycles, an empty
    kernel."""
    import torch

    return graph_ms(lambda: torch.cuda._sleep(0))


# one DFN kernel at one batch: µs per call in one CUDA graph and traced, the
# plain version's and the library call's, the bound
DfnTime = collections.namedtuple("DfnTime", "graph_ms traced_ms plain_ms library_ms bound_ms bound_by")


def dfn_line(name: str, B: int, t: DfnTime, floor: float, library: str, extra: str = "") -> None:
    print(f"  {name} B={B}: kernel {t.graph_ms * 1e3:.2f} in a graph ({(t.graph_ms - floor) * 1e3:.2f} "
          f"over the floor, share {t.bound_ms / t.graph_ms:.4f}), traced {t.traced_ms * 1e3:.2f}; "
          f"plain {t.plain_ms * 1e3:.2f}; {library} {t.library_ms * 1e3:.2f}; bound "
          f"{t.bound_ms * 1e3:.3f} ({t.bound_by}){extra}")


def dfn_forward_times(gen, card: str, floor: float) -> dict:
    """{B: DfnTime} of the DFN forward of the package on sys.path at the
    generator's shape, B = 90 (a training call, 18 stories) and 360 (72) and
    1440, float32, inputs warm in the L2 (on the main path
    image_net and filter_net write them just before). The library call,
    grouped F.conv1d, is one cuDNN kernel per group and is timed in a graph
    at B=90 only (it hung in capture at B >= 360); above, back to back with
    CUDA events."""
    import torch
    import torch.nn.functional as F

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    C, L, K, pad = DFN_SHAPE
    print(f"dfn_forward [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us in a graph (torch.cuda._sleep(0)); share = bound / kernel")
    times = {}
    for B in (90, 360, 1440):
        img = torch.randn(B, C, L, generator=gen, device="cuda")
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda")
        fns = {
            "kernel": lambda: dfn_cuda.dfn_forward(img, filt, pad),
            "plain": lambda: dynamic_filter_conv1d_plain(img, filt, pad),
            "library": lambda: F.conv1d(img.reshape(1, B * C, L), filt.reshape(B, C, K),
                                        padding=pad, groups=B),
        }
        with float32_math():  # the plain einsum and the library conv in float32
            check(torch.allclose(fns["library"]().reshape(B, 1, -1), fns["kernel"](),
                                 rtol=1e-5, atol=1e-5), "grouped conv1d disagrees with the kernel")
            traced = {k: device_ms(f, f"dfn_forward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items() if k != "library" or B == 90}
            library = graphed.get("library") or event_ms(fns["library"])
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"], library,
                           *dfn_bound(B, C, L, K, pad, 4))
        dfn_line("dfn_forward", B, times[B], floor,
                 "grouped conv1d " + ("in a graph" if B == 90 else "back to back"),
                 f"; traced plain {traced['plain'] * 1e3:.2f}, library {traced['library'] * 1e3:.2f}")
    return times


def dfn_backward_times(gen, card: str, floor: float):
    """({B: DfnTime}, {B: ms of the step's backward op}, {B: ms of one dout
    copy}, copies):
    the DFN backward of the package on sys.path at the generator's shape,
    B = 90 (the step's) and 7, inputs warm in the L2. The kernel is timed on a contiguous dout; the op
    is `_DynamicFilterKernel.backward` on the dout the G step hands it, the
    last L_out columns of a (B, ZMC_WIDTH) gradient, with whatever copy the
    op makes first; `copies` is how many it made, seen by a pass-through."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops import dynamic_filter as dfn_op
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    C, L, K, pad = DFN_SHAPE
    L_out = L + 2 * pad - K + 1
    print(f"dfn_backward [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us; op = the autograd Function's backward on the G step's "
          f"row-strided dout (row stride {ZMC_WIDTH}), its copy included")
    times, ops, copy_ms = {}, {}, {}
    for B in (90, 7):
        img = torch.randn(B, C, L, generator=gen, device="cuda")
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda")
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda")[:, -L_out:].unsqueeze(1)
        dout = strided.contiguous()
        ctx = types.SimpleNamespace(saved_tensors=(img, filt), pad=pad)
        fns = {
            "kernel": lambda: dfn_cuda.dfn_backward(img, filt, dout, pad),
            "op": lambda: dfn_op._DynamicFilterKernel.backward(ctx, strided),
            "plain": lambda: dfn_op.dynamic_filter_conv1d_backward_plain(img, filt, dout, pad),
            "library": lambda: torch.ops.aten.convolution_backward(
                dout.view(1, B, L_out), img.view(1, B * C, L), filt.view(B, C, K), None, [1],
                [pad], [1], False, [0], B, [True, True, False]),
            "copy": lambda: strided.contiguous(),
        }
        with float32_math():
            lib, got = fns["library"](), fns["kernel"]()
            check(torch.allclose(lib[0].view(B, C, L), got[0], rtol=1e-5, atol=1e-4)
                  and torch.allclose(lib[1].view(B, 1, C, K), got[1], rtol=1e-5, atol=1e-4),
                  "grouped conv1d backward disagrees with dfn_backward")
            with counting_dfn_backward() as handed:
                fns["op"]()
            copies = int(handed[0][1] != strided.stride())
            traced = {k: device_ms(f, f"dfn_backward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items()}
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"],
                           graphed["library"], *dfn_backward_bound(B, C, L, K, pad))
        ops[B], copy_ms[B] = graphed["op"], graphed["copy"]
        dfn_line("dfn_backward", B, times[B], floor, "convolution_backward in a graph",
                 f"; op {graphed['op'] * 1e3:.2f} in a graph ({copies} dout copy of "
                 f"{graphed['copy'] * 1e3:.2f}), traced {traced['op'] * 1e3:.2f}")
    return times, ops, copy_ms, copies


def dfn_step_ms(card: str, forward: DfnTime, backward_op: float, copies: int, copy_ms: float,
                floor: float) -> float:
    """Prints and returns the DFN pair's Σ launches × graph time over one D+G
    step at B=90: DFN_STEP_LAUNCHES of the forward kernel and of the
    backward op (its dout copies included)."""
    n_f, n_b = DFN_STEP_LAUNCHES["dfn_forward"], DFN_STEP_LAUNCHES["dfn_backward"]
    step = n_f * forward.graph_ms + n_b * backward_op
    print(f"DFN pair per step [{card}]: {n_f} x forward {forward.graph_ms * 1e3:.2f} + {n_b} x "
          f"backward op {backward_op * 1e3:.2f} ({copies} dout copy each, {copy_ms * 1e3:.2f} us) "
          f"= {step * 1e3:.2f} us; {n_f + n_b + n_b * copies} launches, floor x launches "
          f"{(n_f + n_b + n_b * copies) * floor * 1e3:.2f} us")
    return step


@contextlib.contextmanager
def counting_dfn_backward():
    """While open, the DFN backward wrapper records the (shape, strides) of
    each dout it is handed, passing each call on: yields that list."""
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    handed = []
    wrapped = dfn_cuda.dfn_backward

    def call(image, filters, dout, pad):
        handed.append((tuple(dout.shape), dout.stride()))
        return wrapped(image, filters, dout, pad)

    with mock.patch.object(dfn_cuda, "dfn_backward", call):
        yield handed


def bn_bound(name: str, N: int, C: int, S: int):
    """(bound_ms, bound_by) of a BN reduction over float32 (N, C, S): bn_stats
    reads x and writes two [C] sums, 3 operations an element; bn_grad_reduce
    reads x, dy, mean and invstd, 5 operations an element."""
    n = N * C * S
    nbytes = 4 * (n + 2 * C) if name == "bn_stats" else 4 * (2 * n + 4 * C)
    flops = (3 if name == "bn_stats" else 5) * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_generator_state(cfg, stories, seed: int):
    """A full-width generator state_dict: the reference init
    (`train.state.weights_init`) from `seed`, then BN running statistics set
    from one forward pass on the card, each mean shifted and each variance
    scaled at random, so eval BN is far from the identity and the
    activations keep a useful range."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import _batch_motion_content
    from cpcsv_tpu_torch.models.factory import generator_from_config
    from cpcsv_tpu_torch.train.state import weights_init

    net = generator_from_config(cfg).cuda().eval()
    gc = torch.Generator(device="cuda").manual_seed(seed)
    weights_init(net, gc)

    def calibrate(mod, inputs):
        x = inputs[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        mean, var = x.mean(dims), x.var(dims)
        n = mean.numel()
        mod.running_mean.copy_(
            mean + 0.1 * var.sqrt() * torch.randn(n, generator=gc, device="cuda"))
        mod.running_var.copy_(
            var * (0.5 + torch.rand(n, generator=gc, device="cuda")) + 1e-3)

    hooks = [m.register_forward_pre_hook(calibrate) for m in net.modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    motion, content = _batch_motion_content(cfg, stories)
    with torch.no_grad(), float32_math():
        net.sample_videos(torch.from_numpy(motion).cuda(), torch.from_numpy(content).cuda(),
                          generator=gc)
    for h in hooks:
        h.remove()
    return {k: v.cpu() for k, v in net.state_dict().items()}


def bn_modules(net):
    import torch

    return [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def per_step_launches(state) -> dict[str, int]:
    """Each kernel's launches in one D+G step (batches > 1), counted from the
    code (`train/steps.py`, `models/`):
      D step: two generator calls without gradients, each running every G BN
        and the DFN once; per D, `d_phase` encodes real and fake (every
        encoder BN twice) and calls the head three times (real, wrong, fake);
        the backward passes every D BN call.
      G step: two generator calls; per D, `g_phase` encodes the fakes once
        and calls the head once; the backward passes every BN call on the
        loss's path, which is all but the story call's upsample2_seg to
        upsample4_seg (v1 `_decode`: they feed only the mask, and no loss
        reads the story call's mask), and both DFN calls."""
    g = len(bn_modules(state.gen))
    ds = (state.d_se, state.d_im, state.d_st)
    enc = sum(len(bn_modules(d.encode_img)) for d in ds)
    head = sum(len(bn_modules(d.get_cond_logits)) for d in ds)
    d_phase, g_phase = 2 * enc + 3 * head, enc + head
    unread_mask_bns = 3
    return {
        "bn_stats": 2 * g + d_phase + 2 * g + g_phase,
        "bn_grad_reduce": d_phase + 2 * g - unread_mask_bns + g_phase,
        **DFN_STEP_LAUNCHES,
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run on an NVIDIA GPU")
    if not (REPO / "cpcsv_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository (no cpcsv_tpu_torch/)")
    sys.path.insert(0, str(REPO))

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import (
        SyntheticStoryDataset,
        story_batches,
        synthetic_batches,
    )
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops import batchnorm
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import build
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import (
        dynamic_filter_conv1d_backward_plain,
        dynamic_filter_conv1d_plain,
    )
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    def reset_counts() -> None:
        for counts in (dfn_cuda.launches, bn_cuda.launches):
            counts.update(dict.fromkeys(counts, 0))

    def read_counts() -> dict[str, int]:
        return {**dfn_cuda.launches, **bn_cuda.launches}

    # TF32 allowed globally, as cuDNN allows it by default, and for matmuls
    # too: the entry point must hold its float32 itself (phase 4 checks it),
    # and the kernel comparisons and timings open the same float32 scope
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True

    # ---------------------------------------------------------------- 1. card
    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    print(f"global cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # --------------------------------------------------------------- 2. build
    phase("2. build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        logs = dict(zip(build.SOURCES, pool.map(build.build, build.SOURCES)))
    print(f"build {', '.join(build.SOURCES)}, one nvcc each at once: "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        build.load(name)
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # ---------------------------------------------------- 3. kernel vs plain
    phase("3. kernel vs plain")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    C, L = 3, 124
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dfn_plans = set()  # (kernel, taps, vec, warps a block) the cases ran

    def offset_copy(t, offset: int):
        """A contiguous copy of t starting `offset` elements past a 256-byte
        boundary: offset 1 leaves no row 16-byte aligned."""
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    # every instantiation (TAPS), each batch, rows aligned and one element
    # off, and two launches on one input
    for dtype in (torch.float32, torch.bfloat16):
        # float32: the taps are summed in another order; bfloat16: the kernel
        # accumulates in float32 and rounds its output to bfloat16 once
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
            img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda").to(dtype), offset)
            filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype),
                               offset)
            p = dfn_cuda.plan(B, C, L, K, pad, sms, offset == 0)
            dfn_plans.add(("forward", p.taps, p.vec, p.warps))
            out = dfn_cuda.dfn_forward(img, filt, pad)
            with float32_math():
                ref = dynamic_filter_conv1d_plain(img.float(), filt.float(), pad)
            where = f"dfn {dtype} B={B} K={K} pad={pad} offset {offset}"
            check(out.dtype == dtype and out.shape == ref.shape,
                  f"{where}: {out.dtype} {tuple(out.shape)}")
            err = (out.float() - ref).abs()
            check(bool((err <= tol + tol * ref.abs()).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            check(torch.equal(out, dfn_cuda.dfn_forward(img, filt, pad)),
                  f"{where}: two launches differ")
            max_err[dtype] = max(max_err[dtype], err.max().item())
    print(f"dfn kernel vs plain on the card, B in {KERNEL_BATCHES}, K/pad in {TAPS}, rows "
          f"aligned and one element off: max abs error f32 {max_err[torch.float32]:.3e} "
          f"(tol 1e-5), bf16 {max_err[torch.bfloat16]:.3e} (tol 1e-2); two launches give the "
          "same bits")
    # the backward against autograd of the plain version; float32, the sums
    # (up to 124 products) run in another order: 1e-5 + 1e-5·|ref|. dout
    # as the G step hands it over (the last L_out columns of a (B, 613)
    # gradient) and contiguous: the same bits
    bwd_err = 0.0
    for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
        L_out = L + 2 * pad - K + 1
        img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda"), offset)
        filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda"), offset)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda")[:, -L_out:].unsqueeze(1)
        dout = strided.contiguous()
        p = dfn_cuda.plan(B, C, L, K, pad, sms, offset == 0, backward=True)
        dfn_plans.add(("backward", p.taps, p.vec, p.warps))
        got = dfn_cuda.dfn_backward(img, filt, strided, pad)
        with float32_math():
            ref = dynamic_filter_conv1d_backward_plain(img, filt, dout, pad)
        where = f"dfn backward B={B} K={K} pad={pad} offset {offset}"
        for a, r in zip(got, ref):
            err = (a - r).abs()
            check(a.shape == r.shape and bool((err <= 1e-5 + 1e-5 * r.abs()).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            bwd_err = max(bwd_err, err.max().item())
        for again in (dfn_cuda.dfn_backward(img, filt, strided, pad),
                      dfn_cuda.dfn_backward(img, filt, dout, pad)):
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{where}: two launches, or strided and contiguous dout, differ")
    print(f"dfn backward kernel vs autograd of the plain version, B in {KERNEL_BATCHES}, "
          f"K/pad in {TAPS}, rows aligned and one element off, dout with row stride "
          f"{ZMC_WIDTH}: max abs error {bwd_err:.3e} (tol 1e-5 + 1e-5·|ref|); two launches, "
          f"and a contiguous dout, give the same bits; plans (kernel, taps, vec, warps a block) "
          f"on {sms} SMs: {sorted(dfn_plans)}")
    check({t for _, t, _, _ in dfn_plans} == {21, 7, 0},
          f"the cases ran the instantiations {dfn_plans}")

    # ------------------------------------------- 4. the slice at full width
    phase("4. the slice at full width")
    launches = 0
    expected_launches = 0
    slice_fps = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in ("final.yml", "cascade.yml"):
            cfg = config_from_file(name)
            batches = {
                n: next(story_batches(SyntheticStoryDataset(n, seed=args.seed), n))
                for n in STORY_SIZES
            }
            state = random_generator_state(cfg, batches[STORY_SIZES[-1]], args.seed)
            infer = Infer(cfg, state, device="cuda", output_dir=tmp, seed=args.seed)
            rng_states, videos, inside = {}, {}, set()
            hook = infer.net_g.upsample1.register_forward_pre_hook(lambda *_: inside.add(
                (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))

            reset_counts()  # the main path: entry points only
            for n, batch in batches.items():
                rng_states[n] = infer.generator.get_state()
                videos[n], _ = infer.sample_videos_np(batch)
            _, gen_dir = infer.generate_story(
                story_batches(SyntheticStoryDataset(STORY_SIZES[0], seed=args.seed),
                              STORY_SIZES[0]))
            counts = read_counts()
            count = counts["dfn_forward"]
            hook.remove()
            calls = len(batches) + 1
            check(count == calls,
                  f"{name}: dfn kernel launched {count} times in {calls} generator calls")
            check(counts["dfn_backward"] == counts["bn_stats"] == counts["bn_grad_reduce"] == 0,
                  f"{name}: serving (eval BN, no gradients) launched {counts}")
            check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32
                  and torch.backends.cuda.matmul.allow_tf32,
                  f"{name}: TF32 flags (cudnn, matmul) inside the generator {inside}")
            print(f"{name}: TF32 flags (cudnn, matmul) inside the generator {sorted(inside)}, "
                  f"global after {torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32}")
            launches += count
            expected_launches += calls

            pngs = sum(len(f) for _, _, f in os.walk(os.path.dirname(gen_dir)))
            check(pngs == 2 * STORY_SIZES[0] * cfg.VIDEO_LEN,
                  f"{name}: generate_story wrote {pngs} PNGs")
            for n, video in videos.items():
                check(video.shape == (n, cfg.VIDEO_LEN, 64, 64, 3),
                      f"{name}: video shape {video.shape}")
                check(bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
                      f"{name}: frames not finite in [-1, 1]")
                # the same weights and noise with the plain DFN on the card.
                # The DFN's sum order differs by ~1e-6 and passes through the
                # eval BNs and the convolution trunk before the output.
                infer.generator.set_state(rng_states[n])
                with mock.patch.object(generator_module, "dynamic_filter_conv1d",
                                       dynamic_filter_conv1d_plain):
                    plain, _ = infer.sample_videos_np(batches[n])
                diff = float(abs(plain - video).max())
                check(diff <= 1e-3, f"{name} {n} stories: kernel vs plain DFN frames differ by {diff}")
                print(f"{name}: {n} stories -> {video.shape}, |frame| mean "
                      f"{abs(video).mean():.4f} max {abs(video).max():.4f} std "
                      f"{video.std():.4f}; kernel vs plain DFN max abs diff {diff:.3e} (tol 1e-3)")
            print(f"{name}: generate_story wrote {pngs} PNGs; dfn launches {count} in {calls} calls")

            # ------------------------------------------ 5b. slice frames/s
            for n, batch in batches.items():
                for _ in range(2):
                    infer.sample_videos_np(batch)
                times = []
                for _ in range(5):
                    t = time.perf_counter()
                    infer.sample_videos_np(batch)
                    times.append(time.perf_counter() - t)
                med = sorted(times)[len(times) // 2]
                slice_fps[(name, n)] = n * cfg.VIDEO_LEN / med
                print(f"{name}: {n} stories, sample_videos_np {med * 1e3:.2f} ms median of 5 "
                      f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
                      f"{slice_fps[(name, n)]:.1f} frames/s [{card}]")
                # where the time goes: the card's work per call from a trace,
                # against the untraced median call
                dev, _ = trace(lambda: infer.sample_videos_np(batch), 3)
                names = by_name(dev, 3)
                busy = sum(names.values()) / 1e3
                print(f"  trace: device busy {busy:.3f} ms per call in {len(dev) / 3:.0f} ops, "
                      f"idle share {1 - busy / (med * 1e3):.3f}; top: "
                      + "; ".join(f"{k[:70]} {v:.1f} us" for k, v in list(names.items())[:6]))
            print(f"{name}: peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            del infer, state
            torch.cuda.empty_cache()
    check(launches == expected_launches, f"dfn launches {launches} != {expected_launches}")

    # ------------------------------------------------- 5a. kernel timings
    phase("5. kernel timings")
    # the card's cost of one launch in a graph, beside every kernel time
    floor = launch_floor_ms()
    empty = device_ms(lambda: torch.cuda._sleep(0), "empty kernel")
    print(f"launch floor [{card}]: {floor * 1e3:.2f} us per launch in one CUDA graph "
          f"(torch.cuda._sleep(0), an empty kernel); traced {empty * 1e3:.2f} us")
    # the main paths' batches: 90 (a training call, 18 stories), 360 (72)
    fwd = dfn_forward_times(gen, card, floor)
    # the kernels line reports graph times at the main path's B=90: the
    # trace gives the library's 90 per-group cuDNN kernels about four times
    # the graph's time
    kernels = {"dfn_forward": {
        "name": "dfn_forward",
        "route": "cuda",
        "source": dfn_cuda.SOURCE,
        "replaces": dfn_cuda.REPLACES,
        "launches": launches,
        "max_abs_err": max_err[torch.float32],
        "ms": fwd[90].graph_ms,
        "plain_ms": fwd[90].plain_ms,
        "bound_ms": fwd[90].bound_ms,
        "bound_by": fwd[90].bound_by,
        "library_ms": fwd[90].library_ms,
        "floor_ms": floor,
        "step_ms": DFN_STEP_LAUNCHES["dfn_forward"] * fwd[90].graph_ms,
    }}

    # ------------------------------------------ 6. training at full width
    phase("6. training at full width")
    cfg = config_from_file("final.yml")
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    t0 = time.perf_counter()
    state = create_train_state(cfg, args.seed)
    nets = state.nets()
    st_batch, im_batch = (batch_to_device(b, torch.device("cuda"))
                          for b in synthetic_batches(cfg, b_st, b_im, args.seed))
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator(device="cuda").manual_seed(args.seed)
    print(f"final.yml, ST_BATCH {b_st} ({b_st * cfg.VIDEO_LEN} frames), IM_BATCH {b_im}: "
          f"create_train_state and batches {time.perf_counter() - t0:.2f} s; parameters "
          + ", ".join(f"{n} {sum(p.numel() for p in net.parameters()):,}"
                      for n, net in nets.items()))
    before = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()}
    inside = set()
    flags = [mod.register_forward_pre_hook(lambda *_: inside.add(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        for mod in (state.gen.upsample1, state.d_st.get_cond_logits)]
    expected = per_step_launches(state)
    steps = WARMUP_STEPS + TIMED_STEPS
    times, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: the entry points only
    for i in range(steps):
        with contextlib.ExitStack() as stack:
            if i == 0:  # a warm-up step; the shapes are the same every step
                bn_calls = stack.enter_context(counting_bn_calls())
                douts = stack.enter_context(counting_dfn_backward())
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, dm = d_step(state, rng, st_batch, im_batch, LR_D)
            _, gm = g_step(state, rng, st_batch, im_batch, LR_G)
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({**dm, **gm})
    train_counts = read_counts()
    # (N, C, S) -> launches in one step, by kernel
    step_calls = {name: dict(sorted(calls.items())) for name, calls in bn_calls.items()}
    bn_shapes = set(step_calls["bn_stats"]) | set(step_calls["bn_grad_reduce"])
    for name, calls in step_calls.items():
        check(sum(calls.values()) == expected[name],
              f"{name}: {sum(calls.values())} calls counted by shape in one step, "
              f"expected {expected[name]}")
        print(f"{name} calls in one step by (N, C, S), {len(calls)} shapes: "
              + ", ".join(f"{sh} x{n}" for sh, n in calls.items()))
    # the G step hands each DFN backward its dout as the gradient of the
    # concatenation zmc_all left it, a column slice; the wrapper gets that
    # view, so nothing copied it on the way
    L_out = DFN_SHAPE[1] + 2 * DFN_SHAPE[3] - DFN_SHAPE[2] + 1
    check(len(douts) == expected["dfn_backward"]
          and all(sh == (b_im, 1, L_out) and st[0] == ZMC_WIDTH and st[-1] == 1
                  for sh, st in douts),
          f"dfn_backward got dout (shape, strides) {douts} in one step: expected "
          f"{expected['dfn_backward']} views with row stride {ZMC_WIDTH}")
    print(f"dfn_backward was handed in one step dout (shape, strides) {douts}: the column "
          f"slice of zmc_all's gradient, row stride {ZMC_WIDTH}, no copy before the kernel")
    peak = torch.cuda.max_memory_allocated()
    for h in flags:
        h.remove()

    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in values.values()), f"step {i}: metrics {values}")
    print("last step: " + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    for name, per_step in expected.items():
        check(train_counts[name] == per_step * steps,
              f"{name}: {train_counts[name]} launches in {steps} steps, expected {per_step} a step")
    print(f"launches in {steps} D+G steps: {train_counts}; per step from the code: {expected}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32
          and torch.backends.cuda.matmul.allow_tf32,
          f"TF32 flags (cudnn, matmul) inside the steps {inside}")
    print(f"TF32 flags (cudnn, matmul) inside the steps {sorted(inside)}, global after "
          f"{torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32}")
    for n, net in nets.items():
        state_now = net.state_dict()
        still = [k for k, _ in net.named_parameters() if torch.equal(state_now[k], before[n][k])]
        still += [k for k, b in net.named_buffers()
                  if k.endswith(("running_mean", "running_var", "weight_u")) and b.numel() > 1
                  and torch.equal(b, before[n][k])]
        check(not still, f"{n}: unchanged after {steps} steps: {still}")
    print("every parameter, BN running statistic and SN u (but the 1-element u of each "
          "1-output head conv, which stays ±1) moved")
    timed = times[WARMUP_STEPS:]
    med = sorted(timed)[len(timed) // 2]
    print(f"D+G step [{card}]: {med * 1e3:.2f} ms median of {TIMED_STEPS} (min "
          f"{min(timed) * 1e3:.2f}, max {max(timed) * 1e3:.2f}), {1 / med:.3f} steps/s; warm-up "
          + ", ".join(f"{t * 1e3:.2f}" for t in times[:WARMUP_STEPS]) + " ms")
    print(f"peak device memory over the steps {peak / 2**30:.2f} GiB")

    def train_step():
        d_step(state, rng, st_batch, im_batch, LR_D)
        g_step(state, rng, st_batch, im_batch, LR_G)

    dev_events, _ = trace(train_step, 2)
    names = by_name(dev_events, 2)
    busy = sum(names.values()) / 1e3
    ours = {k: v for k, v in names.items()
            if any(f in k for f in ("reduce_maps", "reduce_rows", "finish(", "dfn_"))}
    bn_kernels = {}  # BN device kernels in the 2 traced steps, by name
    for e in dev_events:
        if any(f in e.name for f in ("reduce_maps", "reduce_rows", "finish(")):
            bn_kernels[e.name] = bn_kernels.get(e.name, 0) + 1
    bn_calls_per_step = expected["bn_stats"] + expected["bn_grad_reduce"]
    check(sum(bn_kernels.values()) == 2 * bn_calls_per_step
          and not any("finish(" in k for k in bn_kernels),
          f"2 traced steps ran the BN device kernels {bn_kernels}: expected one per call, "
          f"{bn_calls_per_step} a step, and no finish")
    print(f"  BN device kernels a step: {sum(bn_kernels.values()) / 2:g}, one per call ("
          + "; ".join(f"{k[:60]} x{v / 2:g}" for k, v in bn_kernels.items()) + ")")
    print(f"trace of 2 steps: device busy {busy:.3f} ms a step in {len(dev_events) / 2:.0f} ops, "
          f"idle share {1 - busy / (med * 1e3):.3f}; top: "
          + "; ".join(f"{k[:70]} {v:.1f} us" for k, v in list(names.items())[:8]))
    print(f"  the port's kernels: {sum(ours.values()):.1f} us a step ("
          + "; ".join(f"{k[:50]} {v:.1f} us" for k, v in ours.items()) + ")")

    # ------------------------------- 7. the step: kernels vs plain versions
    phase("7. one D+G step, kernels vs plain versions")
    saved = ({n: {k: v.detach().clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()},
             {n: copy.deepcopy(opt.state_dict()) for n, opt in state.opts.items()})
    g_noise = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    noise = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, g_noise),
              state.gen.draw_noise(b_im, 1, g_noise)) for _ in range(2)]
    plain = (mock.patch.object(batchnorm, "bn_stats", bn_cuda.bn_stats_plain),
             mock.patch.object(batchnorm, "bn_grad_reduce", bn_cuda.bn_grad_reduce_plain),
             mock.patch.object(generator_module, "dynamic_filter_conv1d",
                               dynamic_filter_conv1d_plain))

    def twin(patches):
        for n, net in nets.items():
            net.load_state_dict(saved[0][n])
            # a copy: load_state_dict keeps tensors already on the device,
            # and the Adam step would then update the saved moments in place
            state.opts[n].load_state_dict(copy.deepcopy(saved[1][n]))
        with contextlib.ExitStack() as stack:
            for patch in patches:
                stack.enter_context(patch)
            _, dm = d_step(state, noise[0], st_batch, im_batch, LR_D)
            _, gm = g_step(state, noise[1], st_batch, im_batch, LR_G)
        return ({k: float(v) for k, v in {**dm, **gm}.items()},
                {(n, k): p.grad.detach().clone() for n, net in nets.items()
                 for k, p in net.named_parameters()},
                {(n, k): b.detach().clone() for n, net in nets.items()
                 for k, b in net.named_buffers() if k.endswith(("running_mean", "running_var"))})

    def spread(a, b):
        """(metrics: largest |a-b| / (|b| + 1e-3), accuracies aside;
        accuracies: largest |a-b|; gradients: largest ‖a-b‖ / ‖b‖; gradients
        that are 0 in exact arithmetic (‖b‖ under 1e-3 of the net's largest,
        the Linear biases before a train-mode BN): largest ‖a-b‖ / the net's
        largest ‖b‖; BN statistics: largest ‖a-b‖ / ‖b‖), and the tensors
        with the largest gradient errors."""
        m = max(abs(a[0][k] - b[0][k]) / (abs(b[0][k]) + 1e-3) for k in b[0]
                if not k.startswith("Accuracy/"))
        acc = max(abs(a[0][k] - b[0][k]) for k in b[0] if k.startswith("Accuracy/"))
        largest = {}
        for (n, k), g in b[1].items():
            largest[n] = max(largest.get(n, 0.0), float(g.norm()))
        errs, zero_errs = [(0.0, None)], [(0.0, None)]
        for key, g in b[1].items():
            err, norm = float((a[1][key] - g).norm()), float(g.norm())
            if norm >= 1e-3 * largest[key[0]]:
                errs.append((err / norm, key))
            else:
                zero_errs.append((err / largest[key[0]], key))
        st = max(float((a[2][key] - v).norm()) / float(v.norm()) for key, v in b[2].items())
        errs.sort(key=lambda t: -t[0])
        worst_zero = max(zero_errs, key=lambda t: t[0])
        return ((m, acc, errs[0][0], worst_zero[0], st),
                ([(".".join(key), f"{e:.2e}") for e, key in errs[:5] if key], worst_zero[1]))

    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # cuDNN's backward would add its own spread
    try:
        kern, kern_again, ref = twin(()), twin(()), twin(plain)
    finally:
        torch.backends.cudnn.deterministic = saved_det
    (self_spread, _), (twin_spread, worst) = spread(kern_again, kern), spread(kern, ref)
    # float32, the kernels sum in other orders than the plain versions; the
    # step carries those last-bit differences through BN
    # divisions and two backward passes. The gradients of the motion GRU's
    # path (m_net -> recurrent) amplify them most: 4.1e-3 on the card, while
    # a wrong reduction or DFN backward moves a gradient by O(1). An accuracy
    # counts labels: 0.01 is two of the ~240 positive labels of IM_BATCH 90
    # flipping at p = 0.5.
    tols = (1e-4, 1e-2, 1e-2, 1e-5, 1e-4)
    print("kernels vs plain versions, one D+G step from one state and noise: largest metric "
          "error {:.3e} (tol {:g}), accuracy {:.3e} (tol {:g}), gradient {:.3e} (tol {:g}), "
          "zero gradient {:.3e} (tol {:g}), BN statistics {:.3e} (tol {:g}); worst gradients, "
          "relative and zero: "
          "{}; kernels vs kernels: {:.3e}, {:.3e}, {:.3e}, {:.3e}, {:.3e}".format(
              *(x for pair in zip(twin_spread, tols) for x in pair), worst, *self_spread))
    check(all(e <= t for e, t in zip(twin_spread, tols)),
          f"kernels vs plain step spread {twin_spread} above {tols}")
    del kern, kern_again, ref, saved

    # ------------------------- 8. BN kernels vs plain at the step's shapes
    phase("8. BN kernels vs plain")
    shapes = (sorted(bn_shapes) + sorted({(7, c, sp) for _, c, sp in bn_shapes})
              + list(EDGE_BN_SHAPES))
    bn_err = {"bn_stats": 0.0, "bn_grad_reduce": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = set()  # (kernel, vec, cluster, channels a block) the shapes ran
    # every shape twice: 16-byte aligned, and shifted by one float so that
    # no row starts on a 16-byte boundary
    for (N, Cb, S), offset in ((sh, off) for sh in shapes for off in (0, 1)):
        x, dy = cold_copies(gen, N, Cb, S, 2, offset)
        x += 0.5
        p = bn_cuda.plan(N, Cb, S, sms, x.data_ptr() % 16 == 0)
        plans.add(("reduce_rows" if S == 1 else "reduce_maps", p.vec, p.cluster, p.channels))
        mean = x.mean(dim=(0, 2))
        inv = torch.rsqrt(x.var(dim=(0, 2), correction=0) + 1e-5)
        xhat = (x - mean[:, None]) * inv[:, None]
        results = {
            "bn_stats": (bn_cuda.bn_stats(x), bn_cuda.bn_stats(x), bn_cuda.bn_stats_plain(x),
                         (x.abs().sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)))),
            "bn_grad_reduce": (bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
                               (dy.abs().sum(dim=(0, 2)), (dy * xhat).abs().sum(dim=(0, 2)))),
        }
        for name, (got, again, want, magnitude) in results.items():
            for a, b, r, mag in zip(got, again, want, magnitude):
                # float32 sums in other orders: within 1e-5 of the sum of
                # the terms' magnitudes
                err = (a - r).abs()
                where = f"{name} {(N, Cb, S)} offset {offset}"
                check(torch.equal(a, b), f"{where}: two launches differ")
                check(bool((err <= 1e-5 * mag + 1e-6).all()),
                      f"{where}: kernel vs plain error {err.max().item()}")
                bn_err[name] = max(bn_err[name], err.max().item())
    print(f"BN kernels vs plain on the card at {len(shapes)} shapes (N, C, S), each aligned "
          f"and one float off: the step's {sorted(bn_shapes)}, N=7, and {EDGE_BN_SHAPES}: "
          f"max abs error bn_stats {bn_err['bn_stats']:.3e}, bn_grad_reduce "
          f"{bn_err['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' magnitude + 1e-6); two "
          f"launches give the same bits; plans (kernel, vec, cluster, channels a block) on "
          f"{sms} SMs: {sorted(plans)}")

    # ------------------------------------------------ 9. new kernels' times
    phase("9. kernel timings: the BN reductions at every shape of the step, the DFN backward")

    def bn_library(name: str):
        """One PyTorch call computing the same sums: var_mean (for the
        statistics), native_batch_norm_backward without dx (for the sums)."""
        if name == "bn_stats":
            return lambda x: torch.var_mean(x, dim=(0, 2), correction=0)
        return lambda x, dy, mean, inv: torch.ops.aten.native_batch_norm_backward(
            dy, x, torch.ones_like(mean), None, None, mean, inv, True, 1e-5,
            [False, True, True])

    # Each kernel and its library call at every (N, C, S) the step gave it,
    # one CUDA graph per shape, cycling through input copies that together
    # exceed the L2 (COLD_BYTES), so no call finds its input there.
    print(f"BN per shape [{card}], us per call in one CUDA graph, inputs L2-cold (cycled "
          f"through copies of >= {COLD_BYTES / 1e6:.1f} MB); share = bound / kernel")
    per_shape = {"bn_stats": [], "bn_grad_reduce": []}
    for name, calls in step_calls.items():
        for (N, Cb, S), n_calls in calls.items():
            inputs = bn_cold_inputs(gen, name, N, Cb, S)
            kernel_ms = cold_graph_ms(getattr(bn_cuda, name), inputs)
            library_ms = cold_graph_ms(bn_library(name), inputs)
            bound, bound_by = bn_bound(name, N, Cb, S)
            per_shape[name].append(BnTime((N, Cb, S), n_calls, kernel_ms, library_ms, bound))
            print(f"  {name} N={N} C={Cb} S={S}: {n_calls} a step, kernel {kernel_ms * 1e3:.2f}, "
                  f"library {library_ms * 1e3:.2f}, bound {bound * 1e3:.3f} ({bound_by}), "
                  f"share {bound / kernel_ms:.3f}; {len(inputs)} copies")
            check(bound <= kernel_ms, f"{name} {(N, Cb, S)}: {kernel_ms * 1e3:.2f} us is under "
                  f"its bound {bound * 1e3:.3f} us: the inputs were not L2-cold")
            del inputs
    step_bn = {}  # name -> (kernel, library, bound) ms, summed over a step's launches
    for name, rows in per_shape.items():
        step_bn[name] = tuple(sum(r.calls * getattr(r, k) for r in rows)
                              for k in ("kernel_ms", "library_ms", "bound_ms"))
        kernel_ms, library_ms, bound = step_bn[name]
        print(f"{name} per step [{card}]: {sum(r.calls for r in rows)} launches at {len(rows)} "
              f"shapes; sum of launches x kernel {kernel_ms * 1e3:.2f} us, x library "
              f"{library_ms * 1e3:.2f} us, x bound {bound * 1e3:.2f} us; share of the per-step "
              f"bound {bound / kernel_ms:.3f}")
    kernel_ms, _, bound = (sum(v) for v in zip(*step_bn.values()))
    print(f"BN kernels per step [{card}]: {kernel_ms * 1e3:.2f} us against a bound of "
          f"{bound * 1e3:.2f} us, share {bound / kernel_ms:.3f}")

    # the largest shape: the plain versions in a graph, and a trace of all
    # three (188.7 MB of input, more than the L2 holds, so no copies)
    N, Cb, S = largest = max(bn_shapes, key=lambda sh: sh[0] * sh[1] * sh[2])
    x, dy = cold_copies(gen, N, Cb, S, 2)
    mean = x.mean(dim=(0, 2))
    inv = torch.rsqrt(x.var(dim=(0, 2), correction=0) + 1e-5)
    fns = {
        "bn_stats": {
            "kernel": lambda: bn_cuda.bn_stats(x),
            "plain": lambda: bn_cuda.bn_stats_plain(x),
            "library": lambda: bn_library("bn_stats")(x),
        },
        "bn_grad_reduce": {
            "kernel": lambda: bn_cuda.bn_grad_reduce(x, dy, mean, inv),
            "plain": lambda: bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
            "library": lambda: bn_library("bn_grad_reduce")(x, dy, mean, inv),
        },
    }
    lib = fns["bn_grad_reduce"]["library"]()
    got = bn_cuda.bn_grad_reduce(x, dy, mean, inv)
    check(torch.allclose(lib[2], got[0], rtol=1e-4, atol=1e-2)
          and torch.allclose(lib[1], got[1], rtol=1e-4, atol=1e-2),
          "native_batch_norm_backward disagrees with bn_grad_reduce")
    for name, f in fns.items():
        plain_ms = graph_ms(f["plain"])
        traced = {k: device_ms(fn, f"{name} {k} {largest}") for k, fn in f.items()}
        _, _, kernel_ms, library_ms, bound = next(
            r for r in per_shape[name] if r.shape == largest)
        bound_by = bn_bound(name, N, Cb, S)[1]
        print(f"{name} (N, C, S)={largest} f32 [{card}]: us/call in one CUDA graph kernel "
              f"{kernel_ms * 1e3:.2f}, plain {plain_ms * 1e3:.2f}, library "
              f"{library_ms * 1e3:.2f}; traced "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in traced.items())
              + f"; bound {bound * 1e3:.3f} us ({bound_by})")
        kernels[name] = {
            "name": name, "route": "cuda", "source": bn_cuda.SOURCE,
            "replaces": bn_cuda.REPLACES[name], "launches": train_counts[name],
            "max_abs_err": bn_err[name], "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
            "step_ms": step_bn[name][0], "step_bound_ms": step_bn[name][2],
        }
    del x, dy, fns
    # the DFN backward at the step's batch and a small one, and the pair's
    # time over one D+G step
    bwd, bwd_op, copy_ms, copies = dfn_backward_times(gen, card, floor)
    check(copies == 0, f"the DFN backward op copied a row-strided dout {copies} times")
    dfn_step = dfn_step_ms(card, fwd[90], bwd_op[90], copies, copy_ms[90], floor)
    kernels["dfn_backward"] = {
        "name": "dfn_backward", "route": "cuda", "source": dfn_cuda.SOURCE,
        "replaces": dfn_cuda.REPLACES_BACKWARD, "launches": train_counts["dfn_backward"],
        "max_abs_err": bwd_err, "ms": bwd[90].graph_ms, "plain_ms": bwd[90].plain_ms,
        "bound_ms": bwd[90].bound_ms, "bound_by": bwd[90].bound_by,
        "library_ms": bwd[90].library_ms, "floor_ms": floor,
        "step_ms": DFN_STEP_LAUNCHES["dfn_backward"] * bwd_op[90],
    }
    for name in ("bn_stats", "bn_grad_reduce"):
        kernels[name]["floor_ms"] = floor
    kernels["dfn_forward"]["launches"] += train_counts["dfn_forward"]
    print(f"dfn_forward launches: serving {launches}, training {train_counts['dfn_forward']}")

    phase("done")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
