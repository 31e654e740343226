#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpcsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout with nvcc
     into build/kernels/ (one nvcc per source, all started together), with
     their register lines;
  3. the DFN kernels, forward and backward, against their plain PyTorch
     versions on the card, in float32 and in bfloat16: every instantiation,
     B in KERNEL_BATCHES, rows aligned and one element off, the backward on
     a row-strided dout, two launches giving the same bits;
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
  6. training at full width, final.yml (v1) then cascade.yml, each at
     IM_BATCH 90 / ST_BATCH 18, from `create_train_state` through
     `make_train_steps`: 2 warm-up and 5 timed D+G steps with finite metrics
     (the cascade's three G terms among them), every parameter, BN running
     statistic and SN u moved, each kernel's launches equal to the per-step
     count derived from the code times the steps, the BN calls of one step
     counted by shape, the DFN backward handed the row-strided dout of
     zmc_all's gradient with no copy, float32 inside the steps; ms per step,
     steps/s, device busy time and idle share from a trace, peak memory;
  7. for each config, from one saved state and the same noise, one D+G step
     with the kernels against one with their plain versions swapped in:
     losses, gradients and BN running statistics;
  8. the BN kernels against their plain versions at every (N, C, S) either
     step gave them, at N=7 and at edge shapes, each aligned and unaligned;
     then on bfloat16 x and dy at every shape of the bfloat16 steps
     (phase 16);
  9. the BN kernels and their library calls at every shape of both steps,
     one CUDA graph each with L2-cold inputs, beside their bounds, summed
     over each config's step by launches; the plain versions and a trace at
     the largest shape; the DFN backward at B = 90 and 7 (and the op the step
     runs, on its strided dout) over the floor, and the DFN pair's time a
     step; the same at bfloat16 for the bfloat16 steps, the DFN pair at
     B = 360;
 10. the port's training CLI in this process at full width: cascade.yml
     --synthetic 36 for one epoch, then --continue_ckpt auto for a second
     under a trace, in build/chip_smoke_cli/: the auto-resume, the
     checkpoints, last_epoch.txt, metrics.jsonl (finite, the JAX package's
     cascade tags), the sample grids, the launches against the steps run;
     frames/s, the idle share of the traced epoch's steps, checkpoint write
     seconds;
 11. a procedural Pororo tree of 48 episodes written by the port's writer
     into a temporary directory under build/, and cascade.yml --data_dir on
     it through the CLI for 2 epochs of 34 steps: the launches, finite
     metrics under the cascade tags, the snapshots of epochs 0 and 2; each
     epoch's frames/s, the median step after the first against phase 6's,
     the first-batch wait, the loader's host time a batch, the idle share of
     5 traced steps;
 12. --eval_fid 1, --eval_ssim 1 and --load_ckpt 2 through the CLI on that
     run: a CSV row a snapshot, newest first, finite and tagged random-init;
     the numbered PNGs; the DFN launches; TF32 off inside the extractors;
     each backbone on the card against the CPU; seconds a checkpoint by part
     (generation and PNG writing, PNG reading, Inception, R(2+1)D, the host
     statistics and Frechet);
 13. --eval_fvd 1 twice and --eval_is 1 through the CLI on that run: FVD
     first with no I3D weights (the R(2+1)D fallback), then with a seeded
     random I3D state_dict written as i3d_kinetics400.pth where
     $CPCSV_METRIC_WEIGHTS_DIR points (I3D at 224 x 224 x 10 through the
     file loader): a CSV row a snapshot, newest first, the backbone and the
     tags, the warnings, the DFN launches, TF32 off; I3D and the IS
     classifier on the card against the CPU; seconds a checkpoint by part;
 14. rehearsal.yml (cascade.yml's widths, the in-training FID/FSD every
     epoch) --synthetic 36 --max_epoch 2 through the CLI in a temporary
     working directory: finite Evaluation/fid and Evaluation/vfid each
     epoch, the extractors built once, the real side's .cache/ statistics
     written in epoch 0 and read in epoch 1, a snapshot every epoch, the
     launches; the hook's seconds and share of the epoch, the host Frechet
     apart;
 15. (after 5) story generation at COMPUTE_DTYPE bfloat16, throughput.yml
     (v1) and procedural.yml (cascade), through `Infer` at 18 and 72
     stories: float32 numpy frames finite in [-1, 1], the DFN launches; a
     call of 72 stories under each FUSED_UPSAMPLE, whose frames' spread is
     the yardstick of the relative L2 to the float32 frames of the same
     weights and noise and to the plain DFN's; frames/s, device busy time
     and idle share;
 16. (after 7) training at bfloat16, throughput.yml at IM_BATCH 360 /
     ST_BATCH 72 and procedural.yml at 90 / 18, as phase 6 (2 warm-up and 5
     timed D+G steps, every check of it) with frames/s; then a D+G step under
     each FUSED_UPSAMPLE;
 17. phase 7 for each bfloat16 config, against a yardstick: two plain steps
     whose BN sums run over the batch, then over the map, in reverse order;
 18. the four lowerings side by side: ms of a serving call and of a step;
 19. (after 10) throughput.yml --synthetic 144 through the CLI, one epoch:
     the launches, finite metrics under the v1 tags, float32 checkpoints,
     frames/s;
 20. (after 14) procedural.yml --data_dir on phase 11's tree through the
     CLI, one epoch: the same under the cascade tags.
 21. the training objectives no shipped config turns on, each written as a
     YAML into a temporary directory (`VARIANTS`): final.yml with
     USE_SEQ_CONSISTENCY (the VideoEncoder, the host shuffle), USE_INFONCE
     (the B² pair head) and SEGMENT_LEARNING false, each as phases 6 and 7
     at IM_BATCH 90 / ST_BATCH 18, with frames/s;
 22. throughput.yml with USE_SEQ_CONSISTENCY at bfloat16, 360 / 72, as
     phases 16 and 17;
 23. the BN kernels at the variants' new largest maps (`NEW_BN_MAPS`)
     against their plain versions, then L2-cold in one CUDA graph beside the
     plain version, the library call and the bound;
 24. the seq-consistency variant through the CLI, 2 epochs straight, and 1
     plus an auto-resumed one whose host shuffles and metrics equal the
     straight run's; the SEGMENT_LEARNING false variant for one epoch (no
     netD_se file) and its snapshot served by `Infer`.
The line before the last is a JSON object of the kernels, with bfloat16
times, bounds, library calls and launches (`bf16_*`) beside float32's; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import csv
import io
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
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
LR_D, LR_G = 4e-4, 1e-4  # final.yml's DISCRIMINATOR_LR, GENERATOR_LR (cascade.yml's too)
TRAIN_CONFIGS = ("final.yml", "cascade.yml")  # phases 6-7, in this order
BF16_CONFIGS = ("throughput.yml", "procedural.yml")  # COMPUTE_DTYPE bfloat16, phases 15-20
THROUGHPUT_SYNTHETIC = 144  # phase 19's --synthetic: 2 story steps at ST_BATCH 72
CLI_SYNTHETIC = 36  # phase 10's --synthetic: 2 story steps an epoch, one image batch
DISK_TRACED = (10, 5)  # phase 11: the first of epoch 1's steps under the profiler, and how many
LOADER_ALONE = 4  # phase 11: batches of each loader timed with nothing else running
FVD_FRAMES = 10  # calculate_fvd's frames a clip (phase 13)
# the cascade G step's own metrics, and every tag the JAX package's trainer
# logs for cascade.yml (cpcsv_tpu/train/steps.py, trainer.py)
CASCADE_G_TAGS = ("G/image_vae_loss", "G/video_vae_loss", "G/reconstruct_loss")
CASCADE_TAGS = (
    "seg_D/loss", "seg_D/real", "seg_D/fake", "Accuracy/se_D", "img_D/loss", "img_D/real",
    "img_D/fake", "Accuracy/im_D", "st_D/loss", "st_D/real", "st_D/fake", "st_D/order",
    "G/im_KL", "G/st_KL", "G/KL", "G/consistency", "Accuracy/im_G", "Accuracy/se_G",
    "Accuracy/st_G", "G/gan_loss", "G/loss", *CASCADE_G_TAGS, "learning/generator",
    "learning/st_discriminator", "learning/im_discriminator", "perf/frames_per_sec",
    "perf/epoch_seconds")
WARMUP_STEPS, TIMED_STEPS = 2, 5
GRAPH_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
# phases 21-24: the training objectives no shipped config turns on, each a
# shipped config with the keys flipped, written as a YAML into a temporary
# directory: (file, base config, keys)
VARIANTS = (
    ("final_seq.yml", "final.yml", {"USE_SEQ_CONSISTENCY": True}),
    ("final_infonce.yml", "final.yml", {"USE_INFONCE": True}),
    ("final_noseg.yml", "final.yml", {"SEGMENT_LEARNING": False}),
    ("throughput_seq.yml", "throughput.yml", {"USE_SEQ_CONSISTENCY": True}),
)
# phase 23: the BN kernels at the largest maps the variants give them, the
# InfoNCE head's B² rows and the VideoEncoder's stem, (N, C, S) and dtype
NEW_BN_MAPS = (((8100, 992, 16), "float32"), ((18, 64, 7168), "float32"),
               ((18, 64, 7168), "bfloat16"))
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
        dev = device_events(events)
        if dev:
            break
    check(bool(dev), "torch.profiler recorded no device activity in 3 traces")
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    return dev, host


def device_events(events) -> list:
    """The card's kernels, copies and sets among a trace's events; not the
    device-side copies of record_function ranges, which span kernels."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


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


def cold_copies(gen, N: int, C: int, S: int, count: int, offset: int = 0, dtype=None) -> list:
    """`count` distinct (N, C, S) tensors of `dtype` (float32 by default)
    from one allocation, each starting 256-byte aligned plus `offset`
    elements."""
    import torch

    numel = N * C * S
    row = -(-(numel + offset) // 128) * 128
    buf = torch.randn(count, row, generator=gen, device="cuda").to(dtype or torch.float32)
    return [buf[k, offset:offset + numel].view(N, C, S) for k in range(count)]


def bn_cold_inputs(gen, name: str, N: int, C: int, S: int, dtype=None) -> list:
    """Argument tuples of BN kernel `name` at (N, C, S), x and dy of `dtype`
    (float32 by default), for `cold_graph_ms`: at least 2 distinct copies,
    together more than COLD_BYTES; the copies of bn_grad_reduce share one
    float32 mean and invstd ([C], a few KB)."""
    import torch

    tensors = 1 if name == "bn_stats" else 2
    itemsize = torch.empty(0, dtype=dtype or torch.float32).element_size()
    copies = max(2, -(-COLD_BYTES // (itemsize * N * C * S * tensors)))
    views = cold_copies(gen, N, C, S, copies * tensors, dtype=dtype)
    if name == "bn_stats":
        return [(v,) for v in views]
    mean = views[0].float().mean(dim=(0, 2))
    inv = torch.rsqrt(views[0].float().var(dim=(0, 2), correction=0) + 1e-5)
    return [(views[2 * k], views[2 * k + 1], mean, inv) for k in range(copies)]


def bn_graph_nodes(step_calls: dict, dtype) -> dict:
    """{(kernel, (N, C, S)): Counter of CUgraphNodeType} of one call of each BN
    wrapper at each shape of `step_calls`, on inputs of `dtype`, captured in a
    CUDA graph and read with CUDA's cuGraphGetNodes: what one call runs
    on the card, without a profiler."""
    import ctypes

    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    libcuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    for kernel, calls in step_calls.items():
        for N, C, S in calls:
            x, dy = (torch.randn(N, C, S, device="cuda").to(dtype) for _ in range(2))
            mean, inv = torch.zeros(C, device="cuda"), torch.ones(C, device="cuda")
            args = (x,) if kernel == "bn_stats" else (x, dy, mean, inv)
            fn = getattr(bn_cuda, kernel)
            fn(*args)  # outside the capture: the allocator then holds the blocks
            torch.cuda.synchronize()
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                fn(*args)
            handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
            check(libcuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) == 0,
                  "cuGraphGetNodes failed")
            nodes = (ctypes.c_void_p * count.value)()
            check(libcuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) == 0,
                  "cuGraphGetNodes failed")
            types = collections.Counter()
            for node in nodes:
                t = ctypes.c_int(-1)
                check(libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0,
                      "cuGraphNodeGetType failed")
                types[t.value] += 1
            out[kernel, (N, C, S)] = types
            del graph
    return out


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


def dfn_backward_bound(B: int, C: int, L: int, K: int, pad: int, itemsize: int = 4):
    """(bound_ms, bound_by) of the DFN backward: image, filters and dout read
    once, d image and d filters written once, against its multiply-adds."""
    L_out = L + 2 * pad - K + 1
    nbytes = B * (2 * C * L + 2 * C * K + L_out) * itemsize
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


def dfn_forward_times(gen, card: str, floor: float, dtype=None,
                      batches=(90, 360, 1440)) -> dict:
    """{B: DfnTime} of the DFN forward of the package on sys.path at the
    generator's shape, B = 90 (a training call, 18 stories) and 360 (72) and
    1440, float32 (or `dtype`), inputs warm in the L2 (on the main path
    image_net and filter_net write them just before). The library call,
    grouped F.conv1d, is one cuDNN kernel per group and is timed in a graph
    at B=90 only (it hung in capture at B >= 360); above, back to back with
    CUDA events."""
    import torch
    import torch.nn.functional as F

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    dtype = dtype or torch.float32
    C, L, K, pad = DFN_SHAPE
    # float32: sums in other orders; bfloat16: one rounding of each output
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    print(f"dfn_forward {dtype} [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us in a graph (torch.cuda._sleep(0)); share = bound / kernel")
    times = {}
    for B in batches:
        img = torch.randn(B, C, L, generator=gen, device="cuda").to(dtype)
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype)
        fns = {
            "kernel": lambda: dfn_cuda.dfn_forward(img, filt, pad),
            "plain": lambda: dynamic_filter_conv1d_plain(img, filt, pad),
            "library": lambda: F.conv1d(img.reshape(1, B * C, L), filt.reshape(B, C, K),
                                        padding=pad, groups=B),
        }
        with float32_math():  # the plain einsum and the library conv in float32
            check(torch.allclose(fns["library"]().reshape(B, 1, -1).float(),
                                 fns["kernel"]().float(), rtol=tol, atol=tol),
                  "grouped conv1d disagrees with the kernel")
            traced = {k: device_ms(f, f"dfn_forward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items() if k != "library" or B == 90}
            library = graphed.get("library") or event_ms(fns["library"])
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"], library,
                           *dfn_bound(B, C, L, K, pad, img.element_size()))
        dfn_line("dfn_forward", B, times[B], floor,
                 "grouped conv1d " + ("in a graph" if B == 90 else "back to back"),
                 f"; traced plain {traced['plain'] * 1e3:.2f}, library {traced['library'] * 1e3:.2f}")
    return times


def dfn_backward_times(gen, card: str, floor: float, dtype=None, batches=(90, 7)):
    """({B: DfnTime}, {B: ms of the step's backward op}, {B: ms of one dout
    copy}, copies):
    the DFN backward of the package on sys.path at the generator's shape,
    B = 90 (the step's) and 7, float32 (or `dtype` at `batches`), inputs warm
    in the L2. The kernel is timed on a contiguous dout; the op
    is `_DynamicFilterKernel.backward` on the dout the G step hands it, the
    last L_out columns of a (B, ZMC_WIDTH) gradient, with whatever copy the
    op makes first; `copies` is how many it made, seen by a pass-through."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.ops import dynamic_filter as dfn_op
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    dtype = dtype or torch.float32
    C, L, K, pad = DFN_SHAPE
    L_out = L + 2 * pad - K + 1
    # float32: sums in other orders; bfloat16: one rounding of each output
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
    print(f"dfn_backward {dtype} [{card}]: us per call, inputs warm in L2; launch floor "
          f"{floor * 1e3:.2f} us; op = the autograd Function's backward on the G step's "
          f"row-strided dout (row stride {ZMC_WIDTH}), its copy included")
    times, ops, copy_ms = {}, {}, {}
    for B in batches:
        img = torch.randn(B, C, L, generator=gen, device="cuda").to(dtype)
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda").to(dtype)[
            :, -L_out:].unsqueeze(1)
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
            check(torch.allclose(lib[0].view(B, C, L).float(), got[0].float(), rtol=rtol,
                                 atol=atol)
                  and torch.allclose(lib[1].view(B, 1, C, K).float(), got[1].float(),
                                     rtol=rtol, atol=atol),
                  "grouped conv1d backward disagrees with dfn_backward")
            with counting_dfn_backward() as handed:
                fns["op"]()
            copies = int(handed[0][1] != strided.stride())
            traced = {k: device_ms(f, f"dfn_backward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items()}
        times[B] = DfnTime(graphed["kernel"], traced["kernel"], graphed["plain"],
                           graphed["library"],
                           *dfn_backward_bound(B, C, L, K, pad, img.element_size()))
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


def bn_bound(name: str, N: int, C: int, S: int, itemsize: int = 4):
    """(bound_ms, bound_by) of a BN reduction over (N, C, S) of `itemsize`-byte
    elements (4: float32, 2: bfloat16): bn_stats reads x and writes two
    float32 [C] sums, 3 operations an element; bn_grad_reduce reads x, dy
    and float32 mean and invstd and writes two sums, 5 operations an
    element (float32 arithmetic either way)."""
    n = N * C * S
    nbytes = (itemsize * n + 4 * 2 * C if name == "bn_stats"
              else itemsize * 2 * n + 4 * 4 * C)
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


def per_step_launches(state, infonce: bool = False) -> dict[str, int]:
    """Each kernel's launches in one D+G step (batches > 1), counted from the
    code (`train/steps.py`, `models/`):
      D step: two generator calls without gradients, each running every G BN
        and the DFN once; per D (no seg D without segment learning),
        `d_phase` encodes real and fake (every encoder BN twice) and calls
        the head three times (real, wrong, fake), or with InfoNCE twice
        (the B² pairs, fake); with the order-consistency branch the story D
        runs its VideoEncoder once, on the shuffled stories; the backward
        passes every D BN call.
      G step: two generator calls; for the cascade, two `train_autoencoder`
        calls (the re-encoder's BNs and upsample1_seg to upsample4_seg); per
        D, `g_phase` encodes the fakes once and calls the head once, and the
        story D's VideoEncoder runs on the real stories (no gradient) and on
        the fakes; the backward passes every BN call on the loss's path, and
        both DFN calls. That is every call but the VideoEncoder's on the real
        stories and, in v1 `_decode` with segment learning, the story call's
        upsample2_seg to upsample4_seg: they feed only the mask, and no loss
        reads the story call's mask. In the cascade the story mask feeds the
        re-encoder, which gates the image trunk and the latent loss, so every
        call is on the path."""
    gen = state.gen
    g = len(bn_modules(gen))
    ds = [d for d in (state.d_se, state.d_im, state.d_st) if d is not None]
    enc = sum(len(bn_modules(d.encode_img)) for d in ds)
    head = sum(len(bn_modules(d.get_cond_logits)) for d in ds)
    video = (len(bn_modules(state.d_st.seq_consisten_model))
             if state.d_st.seq_consisten_model is not None else 0)
    d_phase = 2 * enc + (2 if infonce else 3) * head + video
    g_phase = enc + head + 2 * video
    autoencoder = unread_mask_bns = 0
    if gen.cascade:
        autoencoder = sum(len(bn_modules(getattr(gen, m))) for m in (
            "presample", "downsample1_seg", "downsample2_seg", "downsample3_seg",
            "downsample4_seg", "upsample1_seg", "upsample2_seg", "upsample3_seg",
            "upsample4_seg"))
    elif gen.use_segment:
        unread_mask_bns = 3
    return {
        "bn_stats": 2 * g + d_phase + 2 * g + 2 * autoencoder + g_phase,
        "bn_grad_reduce": (d_phase + 2 * g - unread_mask_bns + 2 * autoencoder + g_phase
                           - video),
        **DFN_STEP_LAUNCHES,
    }


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    for counts in (dfn_cuda.launches, bn_cuda.launches):
        counts.update(dict.fromkeys(counts, 0))


def read_counts() -> dict[str, int]:
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda

    return {**dfn_cuda.launches, **bn_cuda.launches}


def train_at_full_width(name: str, seed: int, card: str) -> types.SimpleNamespace:
    """Phase 6 for one config (a shipped config's name, or a variant's YAML
    path, phases 21-22): WARMUP_STEPS + TIMED_STEPS D+G steps at the
    config's batches from `create_train_state` through `make_train_steps`,
    with every check of the phase; with USE_SEQ_CONSISTENCY the story batch
    carries the trainer's host shuffle. Returns what phases 7-9 read."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.losses.shuffle import create_random_shuffle
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    cfg = config_from_file(name)
    name = Path(name).name
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    t0 = time.perf_counter()
    state = create_train_state(cfg, seed)
    nets = state.nets()
    st_host, im_host = synthetic_batches(cfg, b_st, b_im, seed)
    if cfg.USE_SEQ_CONSISTENCY:
        shuffled, order_labels = create_random_shuffle(st_host["images"],
                                                       rng=np.random.default_rng(seed))
        st_host = {**st_host, "shuffled": shuffled, "order_labels": order_labels}
    st_batch, im_batch = (batch_to_device(b, torch.device("cuda")) for b in (st_host, im_host))
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator(device="cuda").manual_seed(seed)
    print(f"{name}, ST_BATCH {b_st} ({b_st * cfg.VIDEO_LEN} frames), IM_BATCH {b_im}: "
          f"create_train_state and batches {time.perf_counter() - t0:.2f} s [{card}]; parameters "
          + ", ".join(f"{n} {sum(p.numel() for p in net.parameters()):,}"
                      for n, net in nets.items()))
    before = {n: {k: v.detach().clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()}
    inside = set()
    flags = [mod.register_forward_pre_hook(lambda *_: inside.add(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        for mod in (state.gen.upsample1, state.d_st.get_cond_logits)]
    expected = per_step_launches(state, cfg.USE_INFONCE)
    steps = WARMUP_STEPS + TIMED_STEPS
    times, metrics = [], []
    torch.cuda.synchronize()
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
    step_calls = {k: dict(sorted(calls.items())) for k, calls in bn_calls.items()}
    for k, calls in step_calls.items():
        check(sum(calls.values()) == expected[k],
              f"{name} {k}: {sum(calls.values())} calls counted by shape in one step, "
              f"expected {expected[k]}")
        print(f"{k} calls in one step by (N, C, S), {len(calls)} shapes: "
              + ", ".join(f"{sh} x{n}" for sh, n in calls.items()))
    # the G step hands each DFN backward its dout as the gradient of the
    # concatenation zmc_all left it, a column slice; the wrapper gets that
    # view, so nothing copied it on the way
    L_out = DFN_SHAPE[1] + 2 * DFN_SHAPE[3] - DFN_SHAPE[2] + 1
    check(len(douts) == expected["dfn_backward"]
          and all(sh == (b_im, 1, L_out) and st[0] == ZMC_WIDTH and st[-1] == 1
                  for sh, st in douts),
          f"{name}: dfn_backward got dout (shape, strides) {douts} in one step: expected "
          f"{expected['dfn_backward']} views with row stride {ZMC_WIDTH}")
    print(f"dfn_backward was handed in one step dout (shape, strides) {douts}: the column "
          f"slice of zmc_all's gradient, row stride {ZMC_WIDTH}, no copy before the kernel")
    peak = torch.cuda.max_memory_allocated()
    for h in flags:
        h.remove()

    for i, m in enumerate(metrics):
        values = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in values.values()), f"{name} step {i}: metrics {values}")
    check(not cfg.CASCADE_MODEL or set(CASCADE_G_TAGS) <= set(values),
          f"{name}: the cascade's metrics {CASCADE_G_TAGS} missing from {sorted(values)}")
    print("last step: " + ", ".join(f"{k} {v:.4f}" for k, v in values.items()))
    for k, per_step in expected.items():
        check(train_counts[k] == per_step * steps,
              f"{name} {k}: {train_counts[k]} launches in {steps} steps, expected {per_step} a step")
    print(f"launches in {steps} D+G steps: {train_counts}; per step from the code: {expected}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32
          and torch.backends.cuda.matmul.allow_tf32,
          f"{name}: TF32 flags (cudnn, matmul) inside the steps {inside}")
    print(f"TF32 flags (cudnn, matmul) inside the steps {sorted(inside)}, global after "
          f"{torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32}")
    for n, net in nets.items():
        state_now = net.state_dict()
        still = [k for k, _ in net.named_parameters() if torch.equal(state_now[k], before[n][k])]
        still += [k for k, b in net.named_buffers()
                  if k.endswith(("running_mean", "running_var", "weight_u")) and b.numel() > 1
                  and torch.equal(b, before[n][k])]
        check(not still, f"{name} {n}: unchanged after {steps} steps: {still}")
    del before
    for n, net in nets.items():
        kept = [*net.parameters(), *(p.grad for p in net.parameters()),
                *(b for k, b in net.named_buffers()
                  if k.endswith(("running_mean", "running_var"))),
                *(v for st in state.opts[n].state.values() for v in st.values() if v.dim() > 0)]
        check(all(t.dtype == torch.float32 for t in kept),
              f"{name} {n}: a parameter, gradient, BN statistic or Adam moment is not float32")
    print("every parameter, BN running statistic and SN u (but the 1-element u of each "
          "1-output head conv, which stays ±1) moved; parameters, gradients, BN statistics "
          "and Adam moments float32")
    timed = times[WARMUP_STEPS:]
    med = sorted(timed)[len(timed) // 2]
    print(f"{name} D+G step [{card}]: {med * 1e3:.2f} ms median of {TIMED_STEPS} (min "
          f"{min(timed) * 1e3:.2f}, max {max(timed) * 1e3:.2f}), {1 / med:.3f} steps/s; warm-up "
          + ", ".join(f"{t * 1e3:.2f}" for t in times[:WARMUP_STEPS]) + " ms")
    print(f"{name} peak device memory over the steps {peak / 2**30:.2f} GiB [{card}]")

    def train_step():
        d_step(state, rng, st_batch, im_batch, LR_D)
        g_step(state, rng, st_batch, im_batch, LR_G)

    bn_calls_per_step = expected["bn_stats"] + expected["bn_grad_reduce"]
    # one call of each BN wrapper at each shape of the step, captured in a CUDA
    # graph: one kernel node and nothing else (no finish kernel, no memset)
    dtype = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else torch.float32
    nodes = bn_graph_nodes(step_calls, dtype)
    check(all(n == {GRAPH_KERNEL_NODE: 1} for n in nodes.values()),
          f"{name}: a BN call's CUDA graph holds other than one kernel node: "
          f"{ {k: dict(n) for k, n in nodes.items() if n != {GRAPH_KERNEL_NODE: 1}} }")
    print(f"  one call of each BN wrapper at each of the step's {len(nodes)} (kernel, shape)s, "
          f"{dtype}, captured in a CUDA graph: one kernel node each")
    # the trace, for the busy time; now and then it loses device events (one
    # to ~110 of the 9,000-16,000 of two steps; in some runs one BN kernel in
    # every trace), so it is taken again, up to 3 times, until it holds one
    # BN kernel a call. A lost event only lowers the count: no trace may hold
    # more, or a finish kernel
    for _ in range(3):
        dev_events, _ = trace(train_step, 2)
        bn_kernels = {}  # BN device kernels in the 2 traced steps, by name
        for e in dev_events:
            if any(f in e.name for f in ("reduce_maps", "reduce_rows", "finish(")):
                bn_kernels[e.name] = bn_kernels.get(e.name, 0) + 1
        traced = sum(bn_kernels.values())
        check(traced <= 2 * bn_calls_per_step and not any("finish(" in k for k in bn_kernels),
              f"{name}: 2 traced steps ran the BN device kernels {bn_kernels}: more than one "
              f"per call ({bn_calls_per_step} a step), or a finish")
        if traced == 2 * bn_calls_per_step:
            break
        print(f"  a trace of 2 steps holds {traced} BN device kernels in {len(dev_events)} "
              f"device events, {bn_calls_per_step} a step launched: traced again")
    names = by_name(dev_events, 2)
    busy = sum(names.values()) / 1e3
    ours = {k: v for k, v in names.items()
            if any(f in k for f in ("reduce_maps", "reduce_rows", "finish(", "dfn_"))}
    print(f"  BN device kernels a step in the trace: {traced / 2:g} of {bn_calls_per_step} ("
          + "; ".join(f"{k[:60]} x{v / 2:g}" for k, v in bn_kernels.items()) + ")")
    print(f"{name} trace of 2 steps [{card}]: device busy {busy:.3f} ms a step in "
          f"{len(dev_events) / 2:.0f} ops, idle share {1 - busy / (med * 1e3):.3f}; top: "
          + "; ".join(f"{k[:70]} {v:.1f} us" for k, v in list(names.items())[:8]))
    print(f"  the port's kernels: {sum(ours.values()):.1f} us a step ("
          + "; ".join(f"{k[:50]} {v:.1f} us" for k, v in ours.items()) + ")")
    return types.SimpleNamespace(
        name=name, cfg=cfg, state=state, st_batch=st_batch, im_batch=im_batch, d_step=d_step,
        g_step=g_step, expected=expected, train_counts=train_counts, step_calls=step_calls,
        step_ms=med * 1e3, busy_ms=busy)


def twin_step(run: types.SimpleNamespace, seed: int) -> None:
    """Phase 7 (17 at bfloat16): from one saved state and the same noise, one
    D+G step with the kernels against one with their plain versions swapped
    in (and one more with the kernels, which must give the same bits but for
    cuDNN). At bfloat16 a float32 sum in another order can move a bfloat16
    rounding, which the step carries on; the yardstick is two more plain
    steps whose BN sums run over the batch, then over the map, in reverse
    order (as the JAX package's two BN arms differ), and the kernels may
    differ from the plain versions by three times the larger spread, or by
    the float32 tolerances. So in float32 too where the story D's
    VideoEncoder is in the step (phase 21): the consistency MSE carries the
    last-bit differences through its eleven train-mode BNs into the
    generator's gradients, which then lie ~1e-2 apart (0.65-0.93 of the
    float32 gradient tolerance in two runs on an H100; on the CPU the port's own
    float32 seq-consistency G gradients lie up to 8e-3 from float64)."""
    import torch

    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops import batchnorm
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    state, cfg = run.state, run.cfg
    nets = state.nets()
    b_st, b_im = cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE
    saved = ({n: {k: v.detach().clone() for k, v in net.state_dict().items()}
              for n, net in nets.items()},
             {n: copy.deepcopy(opt.state_dict()) for n, opt in state.opts.items()})
    g_noise = torch.Generator(device="cuda").manual_seed(seed + 1)
    noise = [(state.gen.draw_noise(b_st, cfg.VIDEO_LEN, g_noise),
              state.gen.draw_noise(b_im, 1, g_noise)) for _ in range(2)]

    def plain_patches(reverse=None):
        """The plain versions, their BN sums over dimension `reverse` of
        (N, C, S) in reverse order if given."""
        def order(t):
            return t if reverse is None else t.flip(reverse)

        return (mock.patch.object(batchnorm, "bn_stats",
                                  lambda x: bn_cuda.bn_stats_plain(order(x))),
                mock.patch.object(batchnorm, "bn_grad_reduce",
                                  lambda x, dy, m, i: bn_cuda.bn_grad_reduce_plain(
                                      order(x), order(dy), m, i)),
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
            _, dm = run.d_step(state, noise[0], run.st_batch, run.im_batch, LR_D)
            _, gm = run.g_step(state, noise[1], run.st_batch, run.im_batch, LR_G)
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
    bf16 = cfg.COMPUTE_DTYPE == "bfloat16"
    yard = bf16 or cfg.USE_SEQ_CONSISTENCY
    try:
        kern, kern_again, ref = twin(()), twin(()), twin(plain_patches())
        reordered = [twin(plain_patches(dim)) for dim in (0, 2)] if yard else []
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
    if yard:
        yardstick = [max(ys) for ys in zip(*(spread(r, ref)[0] for r in reordered))]
        tols = tuple(max(t, 3 * y) for t, y in zip(tols, yardstick))
        print(f"{run.name}: {'bfloat16' if bf16 else 'VideoEncoder'} yardstick, two plain steps "
              "with the BN sums over the batch, "
              "then over the map, in reverse order against the plain step, the larger spread: "
              + ", ".join(f"{y:.3e}" for y in yardstick)
              + "; tolerances three times that or the float32 ones")
    print(f"{run.name}: " + "kernels vs plain versions, one D+G step from one state and noise: largest metric "
          "error {:.3e} (tol {:g}), accuracy {:.3e} (tol {:g}), gradient {:.3e} (tol {:g}), "
          "zero gradient {:.3e} (tol {:g}), BN statistics {:.3e} (tol {:g}); worst gradients, "
          "relative and zero: "
          "{}; kernels vs kernels: {:.3e}, {:.3e}, {:.3e}, {:.3e}, {:.3e}".format(
              *(x for pair in zip(twin_spread, tols) for x in pair), worst, *self_spread))
    check(all(e <= t for e, t in zip(twin_spread, tols)),
          f"{run.name}: kernels vs plain step spread {twin_spread} above {tols}")



def rel_l2(a, ref) -> float:
    """Relative L2 distance of numpy array `a` from `ref`."""
    import numpy as np

    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def set_lowering(net, fused: str) -> None:
    """Every UpBlock of a generator to lowering `fused` (the parameters are
    the same in all four)."""
    from cpcsv_tpu_torch.ops.blocks import UpBlock

    for mod in net.modules():
        if isinstance(mod, UpBlock):
            mod.fused = fused


def bf16_serving(card: str, seed: int) -> dict:
    """Phase 15: story generation at COMPUTE_DTYPE bfloat16 through `Infer`,
    configs throughput.yml (v1) and procedural.yml (cascade), at 18 and 72
    stories, random weights from `seed` with BN statistics calibrated then
    perturbed: float32 numpy frames, finite in [-1, 1]; the DFN forward's
    launches; each lowering's frames and time for a call of 72 stories on
    the same weights and noise, whose spread (bfloat16 rounding alone) is the
    yardstick of the relative L2 to the float32 frames of the same weights
    and noise, and to the frames through the plain DFN; frames/s, device
    busy time and idle share.
    Returns {"launches": dfn_forward launches, "lowering_ms": {config: {fused: ms}},
    "fps": {(config, stories): frames/s}}."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops.blocks import FUSED_UPSAMPLE
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

    out = {"launches": 0, "lowering_ms": {}, "fps": {}}
    for name in BF16_CONFIGS:
        cfg = config_from_file(name)
        check(cfg.COMPUTE_DTYPE == "bfloat16", f"{name}: COMPUTE_DTYPE {cfg.COMPUTE_DTYPE}")
        batches = {n: next(story_batches(SyntheticStoryDataset(n, seed=seed), n))
                   for n in STORY_SIZES}
        state = random_generator_state(cfg, batches[STORY_SIZES[-1]], seed)
        infer = Infer(cfg, state, device="cuda", seed=seed)
        f32 = Infer(cfg.with_updates(COMPUTE_DTYPE="float32"), state, device="cuda", seed=seed)
        check(infer.net_g.dtype == torch.bfloat16 and all(
            p.dtype == torch.float32 for p in infer.net_g.parameters()),
              f"{name}: the generator computes in {infer.net_g.dtype}")
        rng_states, videos = {}, {}
        reset_counts()  # the main path: the entry point only
        for n, batch in batches.items():
            rng_states[n] = infer.generator.get_state()
            videos[n], _ = infer.sample_videos_np(batch)
        counts = read_counts()
        check(counts["dfn_forward"] == len(batches) and counts["dfn_backward"] == 0
              and counts["bn_stats"] == counts["bn_grad_reduce"] == 0,
              f"{name}: bfloat16 serving launched {counts} in {len(batches)} calls")
        out["launches"] += counts["dfn_forward"]
        # each lowering on the same weights and noise, timed at 72 stories:
        # they compute one function and differ by bfloat16 rounding alone, so
        # their spread is the yardstick of bfloat16's distance from float32
        n = STORY_SIZES[-1]
        lowered, out["lowering_ms"][name] = {}, {}
        for fused in FUSED_UPSAMPLE:
            set_lowering(infer.net_g, fused)
            infer.generator.set_state(rng_states[n])
            lowered[fused], _ = infer.sample_videos_np(batches[n])
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                infer.sample_videos_np(batches[n])
                times.append(time.perf_counter() - t)
            out["lowering_ms"][name][fused] = sorted(times)[2] * 1e3
        set_lowering(infer.net_g, cfg.FUSED_UPSAMPLE)
        check(np.array_equal(lowered[cfg.FUSED_UPSAMPLE], videos[n]),
              f"{name}: the same weights and noise gave other frames")
        spread = {f: rel_l2(v, videos[n]) for f, v in lowered.items()}
        # the lowerings round differently in the trunks' upsample convs only;
        # against float32 every layer rounds: three times their spread
        tol = 3 * max(spread.values())
        print(f"{name} bfloat16 serving, {n} stories a call, by FUSED_UPSAMPLE [{card}]: "
              + ", ".join(f"{k} {v:.2f} ms" for k, v in out["lowering_ms"][name].items())
              + f"; relative L2 of each lowering's frames to {cfg.FUSED_UPSAMPLE}'s: "
              + ", ".join(f"{k} {v:.3e}" for k, v in spread.items()))
        for n, video in videos.items():
            check(video.dtype == np.float32 and video.shape == (n, cfg.VIDEO_LEN, 64, 64, 3),
                  f"{name}: bfloat16 serving gave {video.dtype} {video.shape}")
            check(bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
                  f"{name}: bfloat16 frames not finite in [-1, 1]")
            f32.generator.set_state(rng_states[n])
            ref, _ = f32.sample_videos_np(batches[n])
            rel = rel_l2(video, ref)
            infer.generator.set_state(rng_states[n])
            with mock.patch.object(generator_module, "dynamic_filter_conv1d",
                                   dynamic_filter_conv1d_plain):
                plain, _ = infer.sample_videos_np(batches[n])
            diff = rel_l2(plain, video)
            print(f"{name} bfloat16: {n} stories -> {video.shape} float32 numpy, |frame| mean "
                  f"{abs(video).mean():.4f} max {abs(video).max():.4f}; relative L2 to the "
                  f"float32 frames of the same weights and noise {rel:.3e}, to the plain DFN's "
                  f"{diff:.3e} (tol three times the lowerings' spread, {tol:.3e})")
            # bfloat16 against float32: the rounding the lowerings' spread
            # shows, at every layer. The kernel and the plain DFN round the
            # same float32 sums, summed in other orders, to bfloat16; where
            # one rounds the other way, the trunks carry that as the
            # lowerings carry theirs.
            check(rel <= tol, f"{name} {n} stories: bfloat16 frames {rel:.3e} from float32")
            check(diff <= tol, f"{name} {n} stories: kernel vs plain DFN frames {diff:.3e} apart")
        for n, batch in batches.items():
            for _ in range(2):
                infer.sample_videos_np(batch)
            times = []
            for _ in range(5):
                t = time.perf_counter()
                infer.sample_videos_np(batch)
                times.append(time.perf_counter() - t)
            med = sorted(times)[len(times) // 2]
            out["fps"][name, n] = n * cfg.VIDEO_LEN / med
            dev, _ = trace(lambda: infer.sample_videos_np(batch), 3)
            names = by_name(dev, 3)
            busy = sum(names.values()) / 1e3
            print(f"{name} bfloat16: {n} stories, sample_videos_np {med * 1e3:.2f} ms median of 5 "
                  f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
                  f"{out['fps'][name, n]:.1f} frames/s [{card}]; device busy {busy:.3f} ms per "
                  f"call in {len(dev) / 3:.0f} ops, idle share {1 - busy / (med * 1e3):.3f}; top: "
                  + "; ".join(f"{k[:70]} {v:.1f} us" for k, v in list(names.items())[:6]))
        print(f"{name}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
              f"[{card}]")
        del infer, f32, state
        torch.cuda.empty_cache()
    return out


def lowering_steps(run: types.SimpleNamespace, card: str) -> dict:
    """Phase 16's lowerings: each FUSED_UPSAMPLE in turn on the generator of a
    phase 6 record, one warm-up and 3 timed D+G steps (host clock between
    synchronises), the launches checked against the per-step count; the
    config's own lowering restored after. Returns {fused: ms a step}."""
    import torch

    from cpcsv_tpu_torch.ops.blocks import FUSED_UPSAMPLE

    state, cfg = run.state, run.cfg
    rng = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for fused in FUSED_UPSAMPLE:
        set_lowering(state.gen, fused)
        reset_counts()  # the main path: the steps only
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run.d_step(state, rng, run.st_batch, run.im_batch, LR_D)
            run.g_step(state, rng, run.st_batch, run.im_batch, LR_G)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        counts = read_counts()
        check(counts == {k: 4 * v for k, v in run.expected.items()},
              f"{run.name} {fused}: launches {counts} in 4 steps, {run.expected} a step")
        out[fused] = sorted(times[1:])[1] * 1e3
    set_lowering(state.gen, cfg.FUSED_UPSAMPLE)
    frames = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    print(f"{run.name} D+G step by FUSED_UPSAMPLE [{card}], median of 3 after a warm-up: "
          + ", ".join(f"{k} {v:.2f} ms ({frames / v * 1e3:.1f} frames/s)" for k, v in out.items()))
    return out


def cli_epoch(card: str, name: str, data: list, per_step: dict[str, int], steps,
              tags: set, seed: int, root: Path) -> tuple[dict[str, int], Path]:
    """Phases 19-20 and 24: one epoch of config `name` (a shipped config, or
    a variant's YAML path) through the port's CLI in this process, in a
    working directory under `root`, on `data` (the CLI's --synthetic or
    --data_dir arguments): the launches against the D+G steps (`steps`, or
    as many as the story-D metrics logged, one a step) and the sample grid,
    finite metrics under `tags`, the snapshots of epochs 0 and 1 and the full
    state, float32, and netD_se only with a seg D; frames/s and the epoch's
    seconds. Returns the launches and the run directory, which the caller's
    temporary `root` holds."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file

    cfg_file = name if os.path.isabs(name) else str(REPO / "cpcsv_tpu_torch" / "configs" / name)
    name = Path(name).name
    cfg = config_from_file(cfg_file)
    run_root = root / f"cli_{cfg.CONFIG_NAME}"
    run_root.mkdir(parents=True)
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)
    try:
        with contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(["--cfg", cfg_file, *data, "--max_epoch", "1",
                              "--manualSeed", str(seed)])
            run_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"{name} CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_1.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        wanted = f != "netD_se_epoch_last.pth" or cfg.SEGMENT_LEARNING
        check((model / f).is_file() == wanted,
              f"the {name} run wrote {model / f}: {(model / f).is_file()}, expected {wanted}")
    snapshot = torch.load(model / "netG_epoch_1.pth", weights_only=True)
    check(all(v.dtype == torch.float32 for v in snapshot.values() if v.is_floating_point()),
          f"{name}: the snapshot holds other than float32")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    found = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records),
          f"{name}: metrics.jsonl holds a non-finite value")
    check(found == tags, f"{name}: metrics.jsonl tags {sorted(found)}: missing {tags - found}, "
          f"extra {found - tags}")
    logged = sum(r["tag"] == "st_D/loss" for r in records)  # one a step
    steps = steps or logged
    check(logged == steps, f"{name}: {logged} steps logged, expected {steps}")
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 1
    check(counts == expected, f"{name} CLI: launches {counts}, expected {expected} for {steps} "
                              "steps and a sample grid")
    fps = next(r["value"] for r in records if r["tag"] == "perf/frames_per_sec")
    epoch_s = next(r["value"] for r in records if r["tag"] == "perf/epoch_seconds")
    print(f"{name} CLI epoch 0 [{card}]: {steps} D+G steps and a sample grid launched {counts}; "
          f"{fps:.1f} frames/s (perf/frames_per_sec), {epoch_s:.2f} s; {run_s:.2f} s in all, "
          "state init and checkpoints included")
    return counts, run_dir


def cli_trainer(card: str, per_step: dict[str, int], seed: int) -> dict[str, int]:
    """Phase 10: the port's training CLI in this process, on the card, at
    full width: `cascade.yml --synthetic CLI_SYNTHETIC --max_epoch 1`, then
    `--max_epoch 2 --continue_ckpt auto` under a torch.profiler trace, in a
    run directory under build/ that it removes after. Checks the resume, the
    artifacts and the kernels' launches against the steps and sample grids
    run; prints each epoch's frames/s, its steps' time on the host clock and
    the wait for their first batches, the idle share of the traced epoch's
    steps and the checkpoint write times. Returns the launches."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.train import trainer as trainer_module
    from cpcsv_tpu_torch.train.checkpoint import CheckpointManager
    from cpcsv_tpu_torch.train.trainer import EPOCH_STEPS_SPAN

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    run_root = REPO / "build" / "chip_smoke_cli"
    if run_root.exists():
        shutil.rmtree(run_root)
    run_root.mkdir(parents=True)
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    args = ["--cfg", cfg_file, "--synthetic", str(CLI_SYNTHETIC), "--manualSeed", str(seed)]
    steps_an_epoch = max(CLI_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    saves = []  # (epoch, seconds) of each CheckpointManager.save
    real_save = CheckpointManager.save

    def timed_save(self, state, epoch, completed=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        real_save(self, state, epoch, completed)
        saves.append((epoch, time.perf_counter() - t))

    # host clock: each epoch's steps, from the start of the loop to the last
    # step's metrics read back, and the wait before its first D step
    starts, spans, waits = [], [], []
    real_span, real_steps = trainer_module.record_function, trainer_module.make_train_steps

    @contextlib.contextmanager
    def timed_span(name):
        starts.append(time.perf_counter())
        with real_span(name):
            yield
        spans.append(time.perf_counter() - starts[-1])

    def timed_steps(cfg):
        d_step, g_step = real_steps(cfg)

        def d_step_timing_the_first(*args):
            if len(waits) < len(starts):
                waits.append(time.perf_counter() - starts[-1])
            return d_step(*args)

        return d_step_timing_the_first, g_step

    printed = io.StringIO()  # the CLI's output; its config dump is left out below
    cwd = os.getcwd()
    os.chdir(run_root)  # the CLI writes under ./output/torch/
    try:
        with mock.patch.object(CheckpointManager, "save", timed_save), \
                mock.patch.object(trainer_module, "record_function", timed_span), \
                mock.patch.object(trainer_module, "make_train_steps", timed_steps), \
                contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(args + ["--max_epoch", "1"])
            first_s = time.perf_counter() - t
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                main_pororo.main(args + ["--max_epoch", "2", "--continue_ckpt", "auto"])
                torch.cuda.synchronize()
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith(("----[", "Auto-resume", "Continue", "LR DECAY"))]
    print(f"CLI output [{card}] (config dumps left out):\n  " + "\n  ".join(lines))
    check("Auto-resume from epoch 1" in lines,
          "the second CLI run did not print 'Auto-resume from epoch 1'")

    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_1.pth", "netG_epoch_2.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        check((model / f).is_file(), f"the CLI runs wrote no {model / f}")
    check((model / "last_epoch.txt").read_text().strip() == "1",
          f"last_epoch.txt holds {(model / 'last_epoch.txt').read_text()!r}, expected 1")
    for png in ("pororo_00000.png", "pororo_00001.png", "segment_00000.png"):
        check((run_dir / "log" / png).is_file(), f"no sample grid {png}")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    check(tags == set(CASCADE_TAGS), f"metrics.jsonl tags {sorted(tags)} differ from the JAX "
          f"package's cascade set: missing {set(CASCADE_TAGS) - tags}, extra {tags - set(CASCADE_TAGS)}")
    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}

    # 2 epochs of steps_an_epoch D+G steps, and an eval-mode sample grid an
    # epoch (one DFN forward, eval BN)
    steps = 2 * steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 2
    check(counts == expected, f"CLI runs: launches {counts}, expected {expected} for {steps} "
                              "steps and 2 sample grids")
    print(f"CLI runs: {steps} D+G steps and 2 sample grids launched {counts} = {per_step} a "
          "step, plus one dfn_forward a grid")

    # the traced (second) run: the card's busy time inside its epoch's steps
    events = prof.events()
    span = [e for e in events if e.name == EPOCH_STEPS_SPAN and e.device_type == DeviceType.CPU]
    check(len(span) == 1, f"{len(span)} '{EPOCH_STEPS_SPAN}' ranges in the trace of one epoch")
    start, end = span[0].time_range.start, span[0].time_range.end
    dev = device_events(events)
    busy = sum(e.time_range.elapsed_us() for e in dev
               if start <= e.time_range.start and e.time_range.end <= end)
    check(busy > 0, "the trace holds no device work inside the epoch's steps")
    sizes = {f: (model / f).stat().st_size / 2**20 for f in ("netG_epoch_2.pth",
                                                             "train_state_last.pth")}
    check(len(spans) == len(waits) == 2,
          f"{len(spans)} epochs' steps timed in 2 CLI runs of one epoch each")
    frames = steps_an_epoch * (cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE)
    print(f"CLI epoch 0 [{card}]: {fps[0]:.1f} frames/s, {epoch_s[0]:.2f} s for "
          f"{steps_an_epoch} steps and the sample grid; the steps alone {spans[0] * 1e3:.2f} ms "
          f"({frames / spans[0]:.1f} frames/s), of which {waits[0] * 1e3:.2f} ms before the "
          f"first step had its batches (epoch 1: {waits[1] * 1e3:.2f} ms); first run "
          f"{first_s:.2f} s in all, state init and checkpoints included")
    print(f"CLI epoch 1 under torch.profiler [{card}]: {fps[1]:.1f} frames/s; its steps span "
          f"{(end - start) / 1e3:.2f} ms traced ({spans[1] * 1e3:.2f} ms on the host clock), "
          f"device busy {busy / 1e3:.2f} ms: idle share {1 - busy / (end - start):.3f} of the "
          f"traced span, {1 - busy / (spans[0] * 1e6):.3f} of epoch 0's untraced steps")
    print(f"checkpoint writes [{card}]: " + ", ".join(f"epoch {e} {s:.2f} s" for e, s in saves)
          + f"; netG_epoch_2.pth {sizes['netG_epoch_2.pth']:.1f} MiB, train_state_last.pth "
          f"{sizes['train_state_last.pth']:.1f} MiB")
    shutil.rmtree(run_root)  # ~2.5 GB of checkpoints
    return counts


def timing(buckets: dict, key: str, fn):
    """`fn`, adding the host seconds of each call to buckets[key] (a list;
    appends are safe from the loaders' threads)."""
    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            buckets.setdefault(key, []).append(time.perf_counter() - t)

    return timed


def disk_trainer(card: str, per_step: dict[str, int], phase6: types.SimpleNamespace, seed: int,
                 root: Path) -> tuple[dict[str, int], Path, Path]:
    """Phase 11: a procedural Pororo tree (the port's writer, 48 episodes)
    under `root`, then `cascade.yml --data_dir` through the CLI in this
    process for 2 epochs. Checks the launches against the steps and sample
    grids run, finite metrics under the JAX package's cascade tags, and the
    snapshots; prints each epoch's frames/s, its steps' median host time
    after the first (min, max) against phase 6's, the first-batch wait, the
    host time a batch spends in the datasets and the collate, and the idle
    share of 5 traced steps of epoch 1. Returns (launches, run dir, data dir)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data import loader as loader_module
    from cpcsv_tpu_torch.data import pororo
    from cpcsv_tpu_torch.data.procedural import write_procedural_pororo
    from cpcsv_tpu_torch.train import trainer as trainer_module

    data_dir = root / "pororo"
    t = time.perf_counter()
    info = write_procedural_pororo(str(data_dir))
    print(f"procedural tree [{card}]: {info} written in {time.perf_counter() - t:.2f} s")
    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    steps_an_epoch = info["train_clips"] // cfg.TRAIN.ST_BATCH_SIZE
    traced = range(DISK_TRACED[0], DISK_TRACED[0] + DISK_TRACED[1])  # epoch 1's traced steps

    host: dict[str, list] = {}  # host seconds by what ran
    starts, spans, step_starts = [], [], []  # per epoch: the span's start and length, its steps
    window = {}
    real_span, real_steps = trainer_module.record_function, trainer_module.make_train_steps

    @contextlib.contextmanager
    def timed_span(name):
        starts.append(time.perf_counter())
        step_starts.append([])
        with real_span(name):
            yield
        spans.append(time.perf_counter() - starts[-1])

    def timed_steps(cfg):
        d_step, g_step = real_steps(cfg)

        def d_step_timing(*args):
            i = len(step_starts[-1])
            if len(starts) == 2 and i == traced.stop:  # the card drained with the last readback
                window["host_s"] = time.perf_counter() - window.pop("t")
                window["prof"].__exit__(None, None, None)
            step_starts[-1].append(time.perf_counter())
            if len(starts) == 2 and i == traced.start:
                window["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                window["prof"].__enter__()
                window["t"] = time.perf_counter()
            return d_step(*args)

        return d_step_timing, g_step

    def timed_loading(buckets):
        stack = contextlib.ExitStack()
        for obj, attr, key in ((pororo.StoryDataset, "__getitem__", "story item"),
                               (pororo.ImageDataset, "__getitem__", "image item"),
                               (loader_module, "default_collate", "collate")):
            stack.enter_context(mock.patch.object(obj, attr, timing(buckets, key,
                                                                     getattr(obj, attr))))
        return stack

    # the loaders alone, the card idle: the clip-index cache built, then the
    # first LOADER_ALONE batches of the story and the image loader in turn
    alone: dict[str, list] = {}
    with timed_loading(alone):
        t = time.perf_counter()
        image_loader, story_loader, _ = pororo.build_pororo_loaders(
            cfg.with_updates(DATA_DIR=str(data_dir)), seed)
        index_s = time.perf_counter() - t
        walls = {}
        for name, loader in (("story", story_loader), ("image", image_loader)):
            loader.set_epoch(0)
            n = min(LOADER_ALONE, len(loader))
            t = time.perf_counter()
            for _ in itertools.islice(loader, n):
                pass
            walls[name] = (time.perf_counter() - t) / n
    print(f"loaders alone [{card}]: clip index and cache {index_s:.2f} s; a story batch "
          f"{walls['story'] * 1e3:.2f} ms, an image batch {walls['image'] * 1e3:.2f} ms on the "
          f"host clock (first {LOADER_ALONE} of each, read ahead by a thread); host time an item "
          f"{np.mean(alone['story item']) * 1e3:.2f} ms a story, "
          f"{np.mean(alone['image item']) * 1e3:.2f} ms an image, a collate "
          f"{np.mean(alone['collate']) * 1e3:.2f} ms")

    run_root = root / "run"
    run_root.mkdir()
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)
    try:
        with mock.patch.object(trainer_module, "record_function", timed_span), \
                mock.patch.object(trainer_module, "make_train_steps", timed_steps), \
                timed_loading(host), contextlib.redirect_stdout(printed):
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(["--cfg", cfg_file, "--data_dir", str(data_dir), "--max_epoch", "2",
                              "--manualSeed", str(seed)])
            run_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME

    model = run_dir / "Model"
    for f in ("netG_epoch_0.pth", "netG_epoch_2.pth", "train_state_last.pth",
              "netD_im_epoch_last.pth", "netD_st_epoch_last.pth", "netD_se_epoch_last.pth"):
        check((model / f).is_file(), f"the --data_dir run wrote no {model / f}")
    check(not (model / "netG_epoch_1.pth").exists(),
          "a snapshot of epoch 1, which SNAPSHOT_INTERVAL 10 does not take")
    check((model / "last_epoch.txt").read_text().strip() == "1",
          f"last_epoch.txt holds {(model / 'last_epoch.txt').read_text()!r}, expected 1")
    check(all((data_dir / c).is_file() for c in ("img_cache4.npy", "following_cache4.npy")),
          "the loaders wrote no clip-index cache")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    check(tags == set(CASCADE_TAGS), f"metrics.jsonl tags {sorted(tags)} differ from the JAX "
          f"package's cascade set: missing {set(CASCADE_TAGS) - tags}, extra {tags - set(CASCADE_TAGS)}")
    steps = 2 * steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 2
    check(counts == expected, f"--data_dir run: launches {counts}, expected {expected} for "
                              f"{steps} steps and 2 sample grids")
    print(f"--data_dir run: {steps} D+G steps ({steps_an_epoch} an epoch) and 2 sample grids "
          f"launched {counts} = {per_step} a step, plus one dfn_forward a grid")

    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}
    check(len(spans) == 2 and all(len(s) == steps_an_epoch for s in step_starts),
          f"{len(spans)} epochs with {[len(s) for s in step_starts]} steps timed")
    frames_per_step = cfg.TRAIN.ST_BATCH_SIZE * cfg.VIDEO_LEN + cfg.TRAIN.IM_BATCH_SIZE
    for epoch in (0, 1):
        marks = step_starts[epoch] + [starts[epoch] + spans[epoch]]
        steps_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        later = sorted(steps_ms[1:])
        med = later[len(later) // 2]
        wait = (step_starts[epoch][0] - starts[epoch]) * 1e3
        print(f"--data_dir epoch {epoch} [{card}]: {fps[epoch]:.1f} frames/s "
              f"(perf/frames_per_sec), {epoch_s[epoch]:.2f} s; its {steps_an_epoch} steps "
              f"{spans[epoch] * 1e3:.2f} ms on the host clock ({steps_an_epoch * frames_per_step / spans[epoch]:.1f} "
              f"frames/s); first-batch wait {wait:.2f} ms; first step {steps_ms[0]:.2f} ms; "
              f"steps after the first {med:.2f} ms median (min {later[0]:.2f}, max {later[-1]:.2f})"
              + (f", {len(traced)} of them traced" if epoch == 1 else "")
              + f"; phase 6 cascade step {phase6.step_ms:.2f} ms with batches on the card")
    items = {k: len(v) for k, v in host.items()}
    batches = len(host["collate"])
    print(f"loader host time [{card}] (background threads, beside the steps): story batch "
          f"{sum(host['story item']) / (items['story item'] / cfg.TRAIN.ST_BATCH_SIZE) * 1e3:.2f} "
          f"ms in StoryDataset "
          f"({cfg.TRAIN.ST_BATCH_SIZE} stories of {cfg.VIDEO_LEN} PNG frames), image batch "
          f"{sum(host['image item']) / (items['image item'] / cfg.TRAIN.IM_BATCH_SIZE) * 1e3:.2f} ms in "
          f"ImageDataset ({cfg.TRAIN.IM_BATCH_SIZE} frames and masks), collate "
          f"{sum(host['collate']) / batches * 1e3:.2f} ms a batch over {batches} batches; items "
          f"read {items}; host time an item {np.mean(host['story item']) * 1e3:.2f} ms a story, "
          f"{np.mean(host['image item']) * 1e3:.2f} ms an image")
    dev = device_events(window["prof"].events())
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    check(busy > 0, "the trace of epoch 1's steps holds no device work")
    n = len(traced)
    print(f"--data_dir epoch 1, steps {traced.start}-{traced.stop - 1} under torch.profiler "
          f"[{card}]: {window['host_s'] * 1e3 / n:.2f} ms a step on the host clock, device busy "
          f"{busy / n:.2f} ms a step in {len(dev) / n:.0f} ops: idle share "
          f"{1 - busy / (window['host_s'] * 1e3):.3f}; against phase 6's busy "
          f"{phase6.busy_ms:.2f} ms a step, the untraced steps' idle share "
          f"{1 - phase6.busy_ms / med:.3f} (epoch 1's median)")
    print(f"--data_dir run [{card}]: {run_s:.2f} s in all, state init, cache build and "
          "checkpoints included")
    return counts, run_dir, data_dir


class TimedExtractor:
    """An extractor whose calls add their host seconds to host[key] and
    their frames to host[key + " frames"] (the call returns numpy, so the
    card has finished)."""

    def __init__(self, ex, key: str, host: dict):
        self.ex, self.key, self.host = ex, key, host
        self.random_init, self.fingerprint, self.backbone = (ex.random_init, ex.fingerprint,
                                                             ex.backbone)

    def __call__(self, x):
        import numpy as np

        t = time.perf_counter()
        out = self.ex(x)
        self.host.setdefault(self.key, []).append(time.perf_counter() - t)
        self.host.setdefault(f"{self.key} frames", []).append(int(np.prod(np.shape(x)[:-3])))
        return out


def timed_extractor(make, key: str, host: dict, inside: set, built: dict):
    """`make` (a make_*_extractor), its extractor timed, kept in built[key],
    and the TF32 flags its backbone sees added to `inside`."""
    import torch

    def build(path, device):
        ex = make(path, device=device)
        ex.net.register_forward_pre_hook(lambda *_: inside.add(
            (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        built[key] = ex
        return TimedExtractor(ex, key, host)

    return build


def calibrated_copy(net, x, seed: int):
    """A CPU copy of a random-init backbone with BN statistics from one
    train-mode pass over `x` (N, C, ...) and affines drawn away from identity,
    in eval mode: its features depend on the input."""
    import torch

    net = copy.deepcopy(net).cpu()
    gen = torch.Generator().manual_seed(seed)
    bns = [m for m in net.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.momentum = None  # the running statistics become the pass's
            m.weight.uniform_(0.8, 1.2, generator=gen)
            m.bias.normal_(0.0, 0.05, generator=gen)
        net.train()(x)
    for m in bns:
        m.momentum = 0.1
    return net.eval()


def walks(card: str, run_dir: Path, data_dir: Path, seed: int) -> dict[str, int]:
    """Phase 12: --eval_fid 1, --eval_ssim 1 and --load_ckpt 2 through the
    CLI on phase 11's run. Checks one CSV row a snapshot, newest first,
    finite, with the random-init tags; the numbered PNGs; the DFN launches of
    the generations; TF32 off inside the extractors; each backbone's forward
    on the card against the same weights on the CPU. Prints each
    checkpoint's seconds by part (generation and PNG writing, PNG reading,
    each backbone, the host statistics and Frechet) and the backbones'
    frames/s. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import datasets, drivers, features, fid, fsd
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--data_dir", str(data_dir), "--manualSeed", str(seed)]
    epochs = [2, 0]  # phase 11's snapshots, newest first
    test_stories = (len(np.load(data_dir / "train_test_ids.npy", allow_pickle=True)[1])
                    // cfg.TRAIN.ST_BATCH_SIZE * cfg.TRAIN.ST_BATCH_SIZE)
    host: dict[str, list] = {}
    extractors, inside = {}, set()

    patches = [
        mock.patch.object(drivers.Infer, "generate_story",
                          timing(host, "generation and PNG writing", drivers.Infer.generate_story)),
        mock.patch.object(datasets.FolderImageDataset, "__getitem__", timing(
            host, "PNG reading", datasets.FolderImageDataset.__getitem__)),
        mock.patch.object(datasets.FolderStoryDataset, "__getitem__", timing(
            host, "PNG reading", datasets.FolderStoryDataset.__getitem__)),
        mock.patch.object(features, "calculate_activation_statistics", timing(
            host, "statistics", features.calculate_activation_statistics)),
        mock.patch.object(fid, "calculate_frechet_distance", timing(
            host, "Frechet", fid.calculate_frechet_distance)),
        mock.patch.object(fsd, "calculate_frechet_distance", timing(
            host, "Frechet", fsd.calculate_frechet_distance)),
    ]
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_dir.parent.parent.parent)  # the CLI reads ./output/torch/<config>
    try:
        with contextlib.ExitStack() as stack, contextlib.redirect_stdout(printed), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for p in patches:
                stack.enter_context(p)
            for name, key in (("make_inception_extractor", "Inception"),
                              ("make_fsd_extractor", "R(2+1)D")):
                stack.enter_context(mock.patch.object(drivers, name, timed_extractor(
                    getattr(drivers, name), key, host, inside, extractors)))
            reset_counts()  # the main path: the CLI's walks only
            t = time.perf_counter()
            fid_rows = main_pororo.main(args + ["--eval_fid", "1"])
            fid_s = time.perf_counter() - t
            fid_host = {k: list(v) for k, v in host.items()}
            t = time.perf_counter()
            ssim_rows = main_pororo.main(args + ["--eval_ssim", "1"])
            ssim_s = time.perf_counter() - t
            t = time.perf_counter()
            main_pororo.main(args + ["--load_ckpt", "2"])
            dump_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    eval_dir = run_dir / "Evaluation" / cfg.CONFIG_NAME
    with open(eval_dir / "fid_score2.csv") as f:
        fid_csv = [[float(v) for v in row] for row in csv.reader(f)]
    with open(eval_dir / "ssim_score.csv") as f:
        ssim_csv = [[float(v) for v in row] for row in csv.reader(f)]
    check([r["epoch"] for r in fid_rows] == epochs and [r[0] for r in fid_csv] == epochs,
          f"--eval_fid rows {fid_rows}, CSV {fid_csv}: expected epochs {epochs}, newest first")
    check(all(np.isfinite([r["fid"], r["vfid"]]).all() and r["fid_random_init"]
              and r["fsd_random_init"] for r in fid_rows),
          f"--eval_fid rows {fid_rows}: expected finite values tagged random-init")
    check(fid_csv == [[r["epoch"], r["fid"], r["vfid"]] for r in fid_rows],
          f"fid_score2.csv {fid_csv} differs from the rows {fid_rows}")
    check(printed.getvalue().count("[RANDOM-INIT extractors!]") == len(epochs),
          "the --eval_fid lines lack the random-init tag")
    check(sum(issubclass(w.category, RandomInitMetricWarning) for w in caught) == 2,
          f"{len(caught)} warnings in the walks, expected one RandomInitMetricWarning a backbone")
    check([r["epoch"] for r in ssim_rows] == epochs and [r[0] for r in ssim_csv] == epochs
          and all(np.isfinite(r["ssim"]) for r in ssim_rows),
          f"--eval_ssim rows {ssim_rows}, CSV {ssim_csv}")
    pngs = {d: len([f for f in os.listdir(run_dir / "Evaluation" / d) if f.endswith(".png")])
            for d in ("samples", "ref")}
    check(pngs == {"samples": test_stories * cfg.VIDEO_LEN, "ref": test_stories * cfg.VIDEO_LEN},
          f"--load_ckpt 2 wrote {pngs} numbered PNGs, expected {test_stories} test stories x "
          f"{cfg.VIDEO_LEN}")
    # a generate_story per checkpoint and the dump: one DFN forward a story
    # batch; SSIM: one a chunk of 64 stories; eval BN, no gradients
    batches = test_stories // cfg.TRAIN.ST_BATCH_SIZE
    expected = {"dfn_forward": 2 * batches + 2 * -(-test_stories // 64) + batches,
                "dfn_backward": 0, "bn_stats": 0, "bn_grad_reduce": 0}
    check(counts == expected, f"walks: launches {counts}, expected {expected}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32,
          f"TF32 flags (cudnn, matmul) inside the extractors {inside}")
    print(f"walks: launches {counts}; TF32 flags (cudnn, matmul) inside the extractors "
          f"{sorted(inside)}")
    for r in fid_rows:
        print(f"--eval_fid [{card}]: epoch {r['epoch']} fid {r['fid']!r} fsd {r['vfid']!r} "
              f"(random-init extractors: fid {r['fid_random_init']}, fsd {r['fsd_random_init']})")
    for r in ssim_rows:
        print(f"--eval_ssim [{card}]: epoch {r['epoch']} ssim {r['ssim']!r}")
    n = len(epochs)
    parts = ("generation and PNG writing", "PNG reading", "Inception", "R(2+1)D", "statistics",
             "Frechet")
    print(f"--eval_fid walk [{card}]: {fid_s:.2f} s for {n} checkpoints of {test_stories} "
          f"stories, the backbones' construction included; a checkpoint: "
          + ", ".join(f"{k} {sum(fid_host.get(k, [])) / n:.2f} s" for k in parts)
          + f"; the rest {(fid_s - sum(sum(fid_host.get(k, [])) for k in parts)) / n:.2f} s")
    for key in ("Inception", "R(2+1)D"):
        frames = sum(fid_host[f"{key} frames"])
        print(f"  {key} [{card}]: {frames} frames in {sum(fid_host[key]):.2f} s, "
              f"{frames / sum(fid_host[key]):.1f} frames/s (host clock around the calls, "
              "host-to-card copies included)")
    print(f"--eval_ssim walk [{card}]: {ssim_s:.2f} s, {ssim_s / n:.2f} s a checkpoint of "
          f"{test_stories} stories; --load_ckpt 2: {dump_s:.2f} s for "
          f"{2 * test_stories * cfg.VIDEO_LEN} PNGs")

    # each backbone on the card against the same weights on the CPU, its BN
    # calibrated first (calibrated_copy): a random-init backbone's features
    # barely depend on the input, so the raw features could agree while the
    # part that carries the input did not. Both the raw features and the
    # features less their mean over the 4 inputs are held at 1e-3.
    gen = np.random.default_rng(seed)
    for key, shape in (("Inception", (4, 64, 64, 3)),
                       ("R(2+1)D", (4, cfg.VIDEO_LEN, 64, 64, 3))):
        low = 0.0 if key == "Inception" else -1.0  # [0, 1] images, [-1, 1] stories
        calib, x = (torch.from_numpy(gen.uniform(low, 1, shape).astype(np.float32)).movedim(-1, 1)
                    for _ in range(2))
        cpu_net = calibrated_copy(extractors[key].net, calib, seed)
        card_net = copy.deepcopy(cpu_net).cuda()
        with torch.no_grad(), float32_math():
            card_out = card_net(x.cuda()).cpu().numpy()
            cpu_out = cpu_net(x).numpy()
        errs = {}
        for part, a, b in (("raw", card_out, cpu_out),
                           ("centred", card_out - card_out.mean(0), cpu_out - cpu_out.mean(0))):
            errs[part] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        share = float(np.linalg.norm(cpu_out - cpu_out.mean(0)) / np.linalg.norm(cpu_out))
        check(max(errs.values()) <= 1e-3 and share > 5e-2,
              f"{key} on the card against the CPU: relative L2 {errs} (tol 1e-3), the "
              f"input-dependent share of the features {share:.3e} (expected > 5e-2)")
        print(f"{key} forward, BN calibrated, card against CPU, 4 inputs, float32: relative "
              f"L2 {errs['raw']:.3e} raw, {errs['centred']:.3e} less the mean over the inputs "
              f"(tol 1e-3); the centred features are {share:.3e} of the raw ones")
    return counts


def fvd_is_walks(card: str, run_dir: Path, data_dir: Path, seed: int, root: Path) -> dict[str, int]:
    """Phase 13: --eval_fvd 1 twice and --eval_is 1 through the CLI on phase
    11's run. The first FVD walk finds no I3D weights and takes the R(2+1)D
    backbone ("FVD-R"); the second finds a seeded random I3D state_dict
    written as i3d_kinetics400.pth into a directory that
    $CPCSV_METRIC_WEIGHTS_DIR names, and runs I3D at 224 x 224 x 10 through
    the file loader. Checks one CSV row a snapshot, newest first, finite and
    tagged; the backbone each walk took and the warnings; the numbered PNGs;
    the DFN launches; TF32 off inside the backbones; I3D and the IS
    classifier on the card against the CPU, BN calibrated. Prints each walk's
    seconds a checkpoint by part. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation import datasets, drivers, fvd, inception_score
    from cpcsv_tpu_torch.evaluation.i3d import I3D
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning, random_init_

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "cascade.yml")
    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--data_dir", str(data_dir), "--manualSeed", str(seed)]
    epochs = [2, 0]  # phase 11's snapshots, newest first
    test_stories = (len(np.load(data_dir / "train_test_ids.npy", allow_pickle=True)[1])
                    // cfg.TRAIN.ST_BATCH_SIZE * cfg.TRAIN.ST_BATCH_SIZE)
    frames = test_stories * cfg.VIDEO_LEN
    clips = frames // FVD_FRAMES // 16 * 16  # calculate_fvd's batches of 16
    no_weights, i3d_weights = root / "no_weights", root / "i3d_weights"
    no_weights.mkdir()
    i3d_weights.mkdir()
    torch.save(random_init_(I3D(), seed).state_dict(), i3d_weights / "i3d_kinetics400.pth")

    extractors, inside = {}, set()
    walks = (("FVD-R", "--eval_fvd", no_weights, "default_embedder"),
             ("FVD, I3D", "--eval_fvd", i3d_weights, "default_embedder"),
             ("IS", "--eval_is", no_weights, "make_inception_classifier"))
    out = {}
    cwd = os.getcwd()
    os.chdir(run_dir.parent.parent.parent)  # the CLI reads ./output/torch/<config>
    try:
        for name, flag, weights, factory in walks:
            host: dict[str, list] = {}
            patches = [
                mock.patch.dict(os.environ, {"CPCSV_METRIC_WEIGHTS_DIR": str(weights)}),
                mock.patch.object(drivers, factory, timed_extractor(
                    getattr(drivers, factory), name, host, inside, extractors)),
                mock.patch.object(fvd, "calculate_activation_statistics", timing(
                    host, "statistics", fvd.calculate_activation_statistics)),
                mock.patch.object(fvd, "calculate_frechet_distance", timing(
                    host, "Frechet", fvd.calculate_frechet_distance)),
                mock.patch.object(inception_score, "inception_score_from_probs", timing(
                    host, "statistics", inception_score.inception_score_from_probs)),
            ]
            for obj, attr, key in (
                    (drivers.Infer, "inference_samples", "generation and PNG writing"),
                    (drivers.Infer, "generate_story", "generation and PNG writing"),
                    (fvd.VideoGenerateDataset, "__getitem__", "PNG reading"),
                    (datasets.FolderImageDataset, "__getitem__", "PNG reading")):
                patches.append(mock.patch.object(obj, attr, timing(host, key, getattr(obj, attr))))
            printed = io.StringIO()
            with contextlib.ExitStack() as stack, contextlib.redirect_stdout(printed), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for p in patches:
                    stack.enter_context(p)
                reset_counts()  # the main path: the CLI's walk only
                t = time.perf_counter()
                rows = main_pororo.main(args + [flag, "1"])
                seconds = time.perf_counter() - t
                counts = read_counts()
            out[name] = types.SimpleNamespace(rows=rows, host=host, seconds=seconds,
                                              counts=counts, caught=caught,
                                              printed=printed.getvalue())
    finally:
        os.chdir(cwd)

    eval_dir = run_dir / "Evaluation" / cfg.CONFIG_NAME
    with open(eval_dir / "fvd_score.csv") as f:
        fvd_csv = [[float(v) for v in row] for row in csv.reader(f)]
    with open(eval_dir / "is_score.csv") as f:
        is_csv = [[float(v) for v in row] for row in csv.reader(f)]
    batches = test_stories // cfg.TRAIN.ST_BATCH_SIZE
    expected = {"dfn_forward": len(epochs) * batches, "dfn_backward": 0, "bn_stats": 0,
                "bn_grad_reduce": 0}
    for name, (backbone, random_init, warned) in {
            "FVD-R": ("r2plus1d_18", True, ["r2plus1d_18"]), "FVD, I3D": ("i3d", False, []),
            "IS": ("inception_fid", True, ["inception_fid"])}.items():
        w = out[name]
        check([r["epoch"] for r in w.rows] == epochs,
              f"{name} walk rows {w.rows}: expected epochs {epochs}, newest first")
        check(w.counts == expected, f"{name} walk: launches {w.counts}, expected {expected}: one "
                                    "dfn_forward a story batch a checkpoint")
        names = [str(c.message).split(":")[0] for c in w.caught
                 if issubclass(c.category, RandomInitMetricWarning)]
        check(names == warned, f"{name} walk: random-init warnings for {names}, expected {warned}")
        if name == "IS":
            check(all(r["is_random_init"] and np.isfinite([r["is_mean"], r["is_std"]]).all()
                      for r in w.rows), f"IS walk rows {w.rows}: expected finite, tagged random")
            check(w.printed.count("[RANDOM-INIT classifier!]") == len(epochs),
                  "the --eval_is lines lack the random-init tag")
            continue
        check(extractors[name].backbone == backbone
              and all(r["fvd_random_init"] == random_init and np.isfinite(r["fvd"])
                      for r in w.rows),
              f"{name} walk: backbone {extractors[name].backbone}, rows {w.rows}: expected "
              f"backbone {backbone}, finite, random-init {random_init}")
        rounded = [c for c in w.caught if "not divisible by 16" in str(c.message)]
        check(len(rounded) == len(epochs) and f"first {clips} clips" in str(rounded[0].message),
              f"{name} walk: {len(rounded)} round-down warnings, expected one a checkpoint "
              f"({frames // FVD_FRAMES} clips to {clips})")
    check(fvd_csv == [[r["epoch"], r["fvd"]] for name in ("FVD-R", "FVD, I3D")
                      for r in out[name].rows],
          f"fvd_score.csv {fvd_csv} differs from the two walks' rows")
    check(is_csv == [[r["epoch"], r["is_mean"], r["is_std"]] for r in out["IS"].rows],
          f"is_score.csv {is_csv} differs from the rows {out['IS'].rows}")
    pngs = {d: len([f for f in os.listdir(run_dir / "Evaluation" / d) if f.endswith(".png")])
            for d in ("ref", os.path.join(cfg.CONFIG_NAME, "fvd_epoch_0"))}
    check(set(pngs.values()) == {frames}, f"the FVD dumps hold {pngs} PNGs, expected {frames}")
    check(inside == {(False, False)} and torch.backends.cudnn.allow_tf32,
          f"TF32 flags (cudnn, matmul) inside the backbones {inside}")
    print(f"FVD and IS walks: launches {expected} each; TF32 flags (cudnn, matmul) inside the "
          f"backbones {sorted(inside)}")
    for name in ("FVD-R", "FVD, I3D"):
        backbone = extractors[name].backbone
        note = ("; the I3D file holds seeded random weights (random_init_, seed "
                f"{seed}), not Kinetics-400's" if backbone == "i3d" else "")
        for r in out[name].rows:
            print(f"--eval_fvd [{card}]: epoch {r['epoch']} fvd {r['fvd']!r} "
                  f"({backbone}, random-init tag {r['fvd_random_init']}){note}")
    for r in out["IS"].rows:
        print(f"--eval_is [{card}]: epoch {r['epoch']} IS {r['is_mean']!r} +- {r['is_std']!r} "
              f"(random-init classifier: {r['is_random_init']})")

    n = len(epochs)
    for name, w in out.items():
        unit, per = ("frames", 1) if name == "IS" else ("clips", FVD_FRAMES)
        parts = ("generation and PNG writing", "PNG reading", name, "statistics", "Frechet")
        done = sum(w.host[f"{name} frames"]) // per
        print(f"{name} walk [{card}]: {w.seconds:.2f} s for {n} checkpoints of {test_stories} "
              "stories, the backbone's construction included; a checkpoint: "
              + ", ".join(f"{'backbone' if k == name else k} {sum(w.host.get(k, [])) / n:.2f} s"
                          for k in parts)
              + f"; the rest {(w.seconds - sum(sum(w.host.get(k, [])) for k in parts)) / n:.2f} s;"
              f" the backbone {done} {unit} in {sum(w.host[name]):.2f} s, "
              f"{done / sum(w.host[name]):.1f} {unit}/s (host clock around the calls, "
              "host-to-card copies included)")

    # I3D and the IS classifier on the card against the same weights on the
    # CPU, BN calibrated first (calibrated_copy), raw and less the inputs'
    # mean, at 1e-3, as phase 12 holds the other two backbones
    gen = np.random.default_rng(seed)
    for key, shape in (("FVD, I3D", (4, 3, FVD_FRAMES, 64, 64)), ("IS", (4, 3, 64, 64))):
        calib, x = (torch.from_numpy(gen.uniform(0, 1, shape).astype(np.float32))
                    for _ in range(2))
        cpu_net = calibrated_copy(extractors[key].net, calib, seed)
        card_net = copy.deepcopy(cpu_net).cuda()
        with torch.no_grad(), float32_math():
            card_out = card_net(x.cuda()).cpu().numpy()
            cpu_out = cpu_net(x).numpy()
        errs = {part: float(np.linalg.norm(a - b) / np.linalg.norm(b)) for part, a, b in (
            ("raw", card_out, cpu_out),
            ("centred", card_out - card_out.mean(0), cpu_out - cpu_out.mean(0)))}
        share = float(np.linalg.norm(cpu_out - cpu_out.mean(0)) / np.linalg.norm(cpu_out))
        label = "I3D" if key == "FVD, I3D" else "IS classifier"
        check(max(errs.values()) <= 1e-3 and share > 5e-2,
              f"{label} on the card against the CPU: relative L2 {errs} (tol 1e-3), the "
              f"input-dependent share of the outputs {share:.3e} (expected > 5e-2)")
        print(f"{label} forward, BN calibrated, card against CPU, 4 inputs {list(shape)}, "
              f"float32: relative L2 {errs['raw']:.3e} raw, {errs['centred']:.3e} less the mean "
              f"over the inputs (tol 1e-3); the centred outputs are {share:.3e} of the raw ones")
    return {k: sum(w.counts[k] for w in out.values()) for k in expected}


def rehearsal_trainer(card: str, per_step: dict[str, int], seed: int, root: Path) -> dict[str, int]:
    """Phase 14: rehearsal.yml (cascade.yml's widths, EVALUATE_FID_SCORE on,
    a snapshot every epoch) with --synthetic CLI_SYNTHETIC --max_epoch 2
    through the CLI in this process, from a working directory under `root`
    so that its .cache/ lands there. Checks finite Evaluation/fid and
    Evaluation/vfid for both epochs, the extractors built once (one
    random-init warning a backbone), the real side's statistics written in
    epoch 0 and read back in epoch 1, a snapshot every epoch, the launches;
    prints the hook's seconds an epoch and its share of the epoch, the host
    Frechet apart. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.evaluation import features, fid, fsd
    from cpcsv_tpu_torch.evaluation.weights import RandomInitMetricWarning
    from cpcsv_tpu_torch.train import trainer as trainer_module

    cfg_file = str(REPO / "cpcsv_tpu_torch" / "configs" / "rehearsal.yml")
    cfg = config_from_file(cfg_file)
    check(cfg.EVALUATE_FID_SCORE and cfg.TRAIN.SNAPSHOT_INTERVAL == 1,
          f"{cfg_file}: EVALUATE_FID_SCORE {cfg.EVALUATE_FID_SCORE}, SNAPSHOT_INTERVAL "
          f"{cfg.TRAIN.SNAPSHOT_INTERVAL}")
    run_root = root / "rehearsal"
    run_root.mkdir()
    cache = run_root / ".cache"
    host: dict[str, list] = {}
    hooks, built = [], []
    real_vfid = trainer_module.GANTrainer.calculate_vfid
    real_make = trainer_module.make_in_memory_extractors

    def listing():
        return {p.name: p.stat().st_mtime_ns for p in cache.glob("*.npz")}

    def timed_vfid(self, state, epoch, testloader):
        before, marks = listing(), {k: len(host.get(k, [])) for k in ("Frechet", "extraction")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        scores = real_vfid(self, state, epoch, testloader)
        torch.cuda.synchronize()
        hooks.append(types.SimpleNamespace(
            epoch=epoch, seconds=time.perf_counter() - t, before=before, after=listing(),
            frechet=sum(host.get("Frechet", [])[marks["Frechet"]:]),
            extractions=len(host.get("extraction", [])) - marks["extraction"]))
        return scores

    def counted_make(device):
        built.append(device)
        return real_make(device)

    args = ["--cfg", cfg_file, "--synthetic", str(CLI_SYNTHETIC), "--max_epoch", "2",
            "--manualSeed", str(seed)]
    printed = io.StringIO()
    cwd = os.getcwd()
    os.chdir(run_root)  # the CLI writes under ./output/torch/, the hook under ./.cache/
    try:
        with mock.patch.object(trainer_module.GANTrainer, "calculate_vfid", timed_vfid), \
                mock.patch.object(trainer_module, "make_in_memory_extractors", counted_make), \
                mock.patch.object(features, "extract_activations", timing(
                    host, "extraction", features.extract_activations)), \
                mock.patch.object(fid, "calculate_frechet_distance", timing(
                    host, "Frechet", fid.calculate_frechet_distance)), \
                mock.patch.object(fsd, "calculate_frechet_distance", timing(
                    host, "Frechet", fsd.calculate_frechet_distance)), \
                contextlib.redirect_stdout(printed), \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reset_counts()  # the main path: the CLI only
            t = time.perf_counter()
            main_pororo.main(args)
            run_s = time.perf_counter() - t
            counts = read_counts()
    finally:
        os.chdir(cwd)
    lines = [line for line in printed.getvalue().splitlines() if line.startswith("----[")]
    print(f"CLI output [{card}]:\n  " + "\n  ".join(lines))
    run_dir = run_root / "output" / "torch" / cfg.CONFIG_NAME
    for e in (0, 1, 2):
        check((run_dir / "Model" / f"netG_epoch_{e}.pth").is_file(),
              f"rehearsal.yml wrote no netG_epoch_{e}.pth: a snapshot every epoch and the last")
    records = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
    tags = {r["tag"] for r in records}
    check(all(np.isfinite(r["value"]) for r in records), "metrics.jsonl holds a non-finite value")
    want = set(CASCADE_TAGS) | {"Evaluation/fid", "Evaluation/vfid"}
    check(tags == want, f"metrics.jsonl tags: missing {want - tags}, extra {tags - want}")
    scores = {(r["tag"], r["step"]): r["value"] for r in records
              if r["tag"].startswith("Evaluation/")}
    check(sorted(scores) == [(t, e) for t in ("Evaluation/fid", "Evaluation/vfid")
                             for e in (0, 1)],
          f"Evaluation/* records {sorted(scores)}, expected fid and vfid at epochs 0 and 1")
    warned = sorted(str(c.message).split(":")[0] for c in caught
                    if issubclass(c.category, RandomInitMetricWarning))
    check(len(built) == 1 and warned == ["inception_fid", "r2plus1d_18"],
          f"the extractors built {len(built)} times, random-init warnings {warned}: expected "
          "once, one a backbone")
    check([h.epoch for h in hooks] == [0, 1], f"the hook ran at epochs {[h.epoch for h in hooks]}")
    check(not hooks[0].before and len(hooks[0].after) == 2 and hooks[0].extractions == 4,
          f"epoch 0's hook: .cache {hooks[0].before} -> {hooks[0].after}, "
          f"{hooks[0].extractions} feature extractions (expected none -> 2 files, 4)")
    check(hooks[1].before == hooks[1].after == hooks[0].after and hooks[1].extractions == 2,
          f"epoch 1's hook: .cache {hooks[1].before} -> {hooks[1].after}, "
          f"{hooks[1].extractions} extractions (expected the epoch 0 files read back, 2)")
    steps_an_epoch = max(CLI_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    test_stories = max(CLI_SYNTHETIC // 4, cfg.TRAIN.ST_BATCH_SIZE)  # synthetic_loaders' test set
    steps = 2 * steps_an_epoch
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 2 + 2 * -(-test_stories // 64)  # the grids; a hook's chunks
    check(counts == expected, f"rehearsal run: launches {counts}, expected {expected} for "
                              f"{steps} steps, 2 sample grids and 2 hooks")
    print(f"rehearsal run: {steps} D+G steps, 2 sample grids and 2 hooks launched {counts} = "
          f"{per_step} a step, plus one dfn_forward a grid and a hook's chunk of "
          f"{test_stories} test stories; .cache {sorted(hooks[0].after)} written in epoch 0, "
          f"read in epoch 1")
    epoch_s = {r["step"]: r["value"] for r in records if r["tag"] == "perf/epoch_seconds"}
    fps = {r["step"]: r["value"] for r in records if r["tag"] == "perf/frames_per_sec"}
    for h in hooks:
        print(f"rehearsal epoch {h.epoch} [{card}]: fid {scores[('Evaluation/fid', h.epoch)]!r} "
              f"vfid {scores[('Evaluation/vfid', h.epoch)]!r} (random-init extractors); epoch "
              f"{epoch_s[h.epoch]:.2f} s, {fps[h.epoch]:.1f} frames/s; the hook {h.seconds:.2f} s "
              f"({h.seconds / epoch_s[h.epoch]:.3f} of the epoch), of which the host Frechet "
              f"{h.frechet:.2f} s and the rest {h.seconds - h.frechet:.2f} s")
    print(f"rehearsal run [{card}]: {run_s:.2f} s in all, state init and 3 checkpoint saves "
          "included")
    return counts


def bn_vs_plain(gen, shapes: list, dtype) -> tuple[dict, set]:
    """Phase 8 at `dtype`: each BN kernel against its plain version at every
    (N, C, S) of `shapes`, x and dy of `dtype`, each 16-byte aligned and one
    element off (so that no row starts on a 16-byte boundary), two launches
    on one input. Returns ({kernel: max abs error}, {(kernel, vec, cluster,
    channels a block)} the shapes ran)."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    bn_err = {"bn_stats": 0.0, "bn_grad_reduce": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = set()
    for (N, Cb, S), offset in ((sh, off) for sh in shapes for off in (0, 1)):
        x, dy = cold_copies(gen, N, Cb, S, 2, offset, dtype)
        x += 0.5
        p = bn_cuda.plan(N, Cb, S, sms, x.data_ptr() % 16 == 0, x.element_size())
        plans.add(("reduce_rows" if S == 1 else "reduce_maps", p.vec, p.cluster, p.channels))
        xf, dyf = x.float(), dy.float()
        mean = xf.mean(dim=(0, 2))
        inv = torch.rsqrt(xf.var(dim=(0, 2), correction=0) + 1e-5)
        xhat = (xf - mean[:, None]) * inv[:, None]
        results = {
            "bn_stats": (bn_cuda.bn_stats(x), bn_cuda.bn_stats(x), bn_cuda.bn_stats_plain(x),
                         (xf.abs().sum(dim=(0, 2)), (xf * xf).sum(dim=(0, 2)))),
            "bn_grad_reduce": (bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                               bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
                               (dyf.abs().sum(dim=(0, 2)), (dyf * xhat).abs().sum(dim=(0, 2)))),
        }
        for name, (got, again, want, magnitude) in results.items():
            for a, b, r, mag in zip(got, again, want, magnitude):
                # float32 sums in other orders: within 1e-5 of the sum of
                # the terms' magnitudes
                err = (a - r).abs()
                where = f"{name} {dtype} {(N, Cb, S)} offset {offset}"
                check(a.dtype == torch.float32, f"{where}: the sums are {a.dtype}")
                check(torch.equal(a, b), f"{where}: two launches differ")
                check(bool((err <= 1e-5 * mag + 1e-6).all()),
                      f"{where}: kernel vs plain error {err.max().item()}")
                bn_err[name] = max(bn_err[name], err.max().item())
    return bn_err, plans


def bn_library(name: str):
    """One PyTorch call computing the same sums: var_mean (for the
    statistics), native_batch_norm_backward without dx (for the sums)."""
    import torch

    if name == "bn_stats":
        return lambda x: torch.var_mean(x, dim=(0, 2), correction=0)
    return lambda x, dy, mean, inv: torch.ops.aten.native_batch_norm_backward(
        dy, x, torch.ones_like(mean), None, None, mean, inv, True, 1e-5, [False, True, True])


def bn_timings(gen, card: str, runs: dict, dtype):
    """Phase 9, for the steps of `runs` ({config: phase 6's record}) at
    `dtype`: each BN kernel and its library call at every (N, C, S) a step
    gave it, one CUDA graph per shape, cycling through input copies that
    together exceed the L2 (COLD_BYTES), so no call finds its input there;
    then each config's sums over a step's launches. Returns (per_shape,
    step_bn): {(kernel, (N, C, S)): BnTime with calls = launches a step of
    each config}, {config: {kernel: (kernel, library, bound) ms a step}}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    itemsize = torch.empty(0, dtype=dtype).element_size()
    print(f"BN per shape, {dtype} [{card}], us per call in one CUDA graph, inputs L2-cold "
          f"(cycled through copies of >= {COLD_BYTES / 1e6:.1f} MB); share = bound / kernel")
    per_shape = {}
    for name in ("bn_stats", "bn_grad_reduce"):
        for N, Cb, S in sorted(set().union(*(r.step_calls[name] for r in runs.values()))):
            calls = {c: r.step_calls[name].get((N, Cb, S), 0) for c, r in runs.items()}
            inputs = bn_cold_inputs(gen, name, N, Cb, S, dtype)
            kernel_ms = cold_graph_ms(getattr(bn_cuda, name), inputs)
            library_ms = cold_graph_ms(bn_library(name), inputs)
            bound, bound_by = bn_bound(name, N, Cb, S, itemsize)
            per_shape[name, (N, Cb, S)] = BnTime((N, Cb, S), calls, kernel_ms, library_ms, bound)
            print(f"  {name} N={N} C={Cb} S={S}: a step "
                  + ", ".join(f"{c} x{n}" for c, n in calls.items())
                  + f"; kernel {kernel_ms * 1e3:.2f}, library {library_ms * 1e3:.2f}, bound "
                  f"{bound * 1e3:.3f} ({bound_by}), share {bound / kernel_ms:.3f}; "
                  f"{len(inputs)} copies")
            check(bound <= kernel_ms, f"{name} {(N, Cb, S)}: {kernel_ms * 1e3:.2f} us is under "
                  f"its bound {bound * 1e3:.3f} us: the inputs were not L2-cold")
            del inputs
    step_bn = {c: {} for c in runs}
    for c in runs:
        for name in ("bn_stats", "bn_grad_reduce"):
            rows = [r for (k, _), r in per_shape.items() if k == name and r.calls[c]]
            step_bn[c][name] = tuple(sum(r.calls[c] * getattr(r, k) for r in rows)
                                     for k in ("kernel_ms", "library_ms", "bound_ms"))
            kernel_ms, library_ms, bound = step_bn[c][name]
            print(f"{c} {name} per step [{card}]: {sum(r.calls[c] for r in rows)} launches at "
                  f"{len(rows)} shapes; sum of launches x kernel {kernel_ms * 1e3:.2f} us, x "
                  f"library {library_ms * 1e3:.2f} us, x bound {bound * 1e3:.2f} us; share of the "
                  f"per-step bound {bound / kernel_ms:.3f}")
        kernel_ms, _, bound = (sum(v) for v in zip(*step_bn[c].values()))
        print(f"{c} BN kernels per step [{card}]: {kernel_ms * 1e3:.2f} us against a bound of "
              f"{bound * 1e3:.2f} us, share {bound / kernel_ms:.3f}")
    return per_shape, step_bn


def bn_largest(gen, card: str, runs: dict, per_shape: dict, dtype) -> dict:
    """Phase 9 at the largest shape the steps of `runs` gave the BN kernels,
    at `dtype`: the plain versions in a graph, and a trace of kernel, plain
    version and library call (the input, 188.7 MB or more, exceeds the L2,
    so no copies); the library's sums held against the kernel's. Returns
    {kernel: {"shape", "plain_ms", "bound_by"}}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                           for r in runs.values()))
    N, Cb, S = largest = max(shapes, key=lambda sh: sh[0] * sh[1] * sh[2])
    x, dy = cold_copies(gen, N, Cb, S, 2, dtype=dtype)
    mean = x.float().mean(dim=(0, 2))
    inv = torch.rsqrt(x.float().var(dim=(0, 2), correction=0) + 1e-5)
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
    # the sums' largest distance from float64's, over the sum of the terms'
    # magnitudes, for the library and for the kernel; float64 a few rows at
    # a time (the whole map would take tens of GB)
    exact = [torch.zeros(Cb, dtype=torch.float64, device="cuda") for _ in range(4)]
    for i in range(0, N, 16):
        dyd = dy[i:i + 16].double()
        xhat = (x[i:i + 16].double() - mean.double()[:, None]) * inv.double()[:, None]
        for acc, t in zip(exact, (dyd, dyd * xhat, dyd.abs(), (dyd * xhat).abs())):
            acc += t.sum(dim=(0, 2))
    del dyd, xhat
    off = {who: max(float(((a.double() - e).abs() / m).max())
                    for a, e, m in zip(sums, exact[:2], exact[2:]))
           for who, sums in (("library", (lib[2], lib[1])), ("kernel", got))}
    print(f"bn_grad_reduce {largest} {dtype}: the sums' largest distance from float64's over "
          f"the sum of the terms' magnitudes: library {off['library']:.3e}, kernel "
          f"{off['kernel']:.3e}")
    if dtype == torch.float32:
        close = (torch.allclose(lib[2], got[0], rtol=1e-4, atol=1e-2)
                 and torch.allclose(lib[1], got[1], rtol=1e-4, atol=1e-2))
    else:
        # the library's sums of bfloat16 inputs lie off float64's by far more
        # than float32 rounding, where the kernel's do not: held within one
        # bfloat16 step of the terms' magnitudes
        close = off["library"] <= 2 ** -8 and off["kernel"] <= 1e-5
    check(close, f"native_batch_norm_backward disagrees with bn_grad_reduce at {dtype}")
    out = {}
    for name, f in fns.items():
        plain_ms = graph_ms(f["plain"])
        traced = {k: device_ms(fn, f"{name} {k} {largest} {dtype}") for k, fn in f.items()}
        _, _, kernel_ms, library_ms, bound = per_shape[name, largest]
        bound_by = bn_bound(name, N, Cb, S, x.element_size())[1]
        print(f"{name} (N, C, S)={largest} {dtype} [{card}]: us/call in one CUDA graph kernel "
              f"{kernel_ms * 1e3:.2f}, plain {plain_ms * 1e3:.2f}, library "
              f"{library_ms * 1e3:.2f}; traced "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in traced.items())
              + f"; bound {bound * 1e3:.3f} us ({bound_by})")
        out[name] = {"shape": largest, "plain_ms": plain_ms, "bound_by": bound_by}
    return out


def write_variants(root: Path) -> dict[str, str]:
    """Each of VARIANTS as a YAML file in `root`: the base config's keys with
    the variant's flipped, under a CONFIG_NAME of its own. Returns {file:
    path}."""
    import yaml

    paths = {}
    for fname, base, keys in VARIANTS:
        raw = yaml.safe_load((REPO / "cpcsv_tpu_torch" / "configs" / base).read_text())
        raw.update(keys, CONFIG_NAME=f"{raw['CONFIG_NAME']}_{Path(fname).stem}")
        paths[fname] = str(root / fname)
        Path(paths[fname]).write_text(yaml.safe_dump(raw))
    return paths


def bn_new_maps(gen, card: str) -> dict:
    """Phase 23: the BN kernels at NEW_BN_MAPS, held against their plain
    versions (each input 16-byte aligned and one element off, two launches),
    then in one CUDA graph each with L2-cold inputs as phase 9: kernel,
    plain version and library call against the bound. Returns {kernel:
    [{shape, dtype, max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}]}."""
    import torch

    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda

    out = {"bn_stats": [], "bn_grad_reduce": []}
    for shape, dtype_name in NEW_BN_MAPS:
        dtype = getattr(torch, dtype_name)
        err, plans = bn_vs_plain(gen, [shape], dtype)
        for name in out:
            inputs = bn_cold_inputs(gen, name, *shape, dtype)
            kernel_ms = cold_graph_ms(getattr(bn_cuda, name), inputs)
            plain_ms = cold_graph_ms(getattr(bn_cuda, f"{name}_plain"), inputs)
            library_ms = cold_graph_ms(bn_library(name), inputs)
            bound, bound_by = bn_bound(name, *shape, torch.empty(0, dtype=dtype).element_size())
            del inputs
            check(bound <= kernel_ms, f"{name} {shape} {dtype_name}: {kernel_ms * 1e3:.2f} us is "
                  f"under its bound {bound * 1e3:.3f} us: the inputs were not L2-cold")
            print(f"{name} (N, C, S)={shape} {dtype_name} [{card}]: kernel vs plain max abs error "
                  f"{err[name]:.3e} (tol 1e-5 of the terms' magnitude + 1e-6), plans {sorted(plans)}; "
                  f"us a call in one CUDA graph, L2-cold: kernel {kernel_ms * 1e3:.2f}, plain "
                  f"{plain_ms * 1e3:.2f}, library {library_ms * 1e3:.2f}, bound "
                  f"{bound * 1e3:.3f} ({bound_by}), share {bound / kernel_ms:.3f}")
            out[name].append({"shape": list(shape), "dtype": dtype_name,
                              "max_abs_err": err[name], "ms": kernel_ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": bound, "bound_by": bound_by})
        torch.cuda.empty_cache()
    return out


def seq_cli(card: str, cfg_file: str, per_step: dict[str, int], seed: int,
            root: Path) -> dict[str, int]:
    """Phase 24, the seq-consistency variant through the port's CLI in this
    process: --synthetic CLI_SYNTHETIC for 2 epochs straight, then in
    another working directory 1 epoch and a --continue_ckpt auto epoch. The
    resumed epoch's host shuffles equal the straight run's epoch 1 bit for
    bit, and its metrics equal them within 1e-4 (cuDNN held deterministic);
    the launches against the steps and grids run. Returns the launches."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.cli import main_pororo
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.train import trainer as trainer_module

    cfg = config_from_file(cfg_file)
    args = ["--cfg", cfg_file, "--synthetic", str(CLI_SYNTHETIC), "--manualSeed", str(seed)]
    steps_an_epoch = max(CLI_SYNTHETIC, cfg.TRAIN.ST_BATCH_SIZE) // cfg.TRAIN.ST_BATCH_SIZE
    shuffles = []  # (shuffled stories, labels) bytes of every host shuffle, in order
    real_shuffle = trainer_module.create_random_shuffle

    def recorded(stories, **kwargs):
        shuffled, labels = real_shuffle(stories, **kwargs)
        shuffles.append((shuffled.tobytes(), labels.tobytes(), labels.sum()))
        return shuffled, labels

    runs, printed = {}, io.StringIO()
    cwd = os.getcwd()
    saved_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    reset_counts()  # the main path: the CLI only
    t = time.perf_counter()
    try:
        with mock.patch.object(trainer_module, "create_random_shuffle", recorded), \
                contextlib.redirect_stdout(printed):
            for label, invocations in (("straight", (["--max_epoch", "2"],)),
                                       ("resumed", (["--max_epoch", "1"],
                                                    ["--max_epoch", "2", "--continue_ckpt",
                                                     "auto"]))):
                work = root / f"seq_cli_{label}"
                work.mkdir()
                os.chdir(work)
                first = len(shuffles)
                for extra in invocations:
                    main_pororo.main(args + extra)
                runs[label] = (work / "output" / "torch" / cfg.CONFIG_NAME, shuffles[first:])
        counts = read_counts()
    finally:
        os.chdir(cwd)
        torch.backends.cudnn.deterministic = saved_det
    seconds = time.perf_counter() - t
    lines = [line for line in printed.getvalue().splitlines()
             if line.startswith(("----[", "Auto-resume"))]
    print(f"{Path(cfg_file).name} CLI output [{card}]:\n  " + "\n  ".join(lines))
    check("Auto-resume from epoch 1" in lines, "the resumed run did not auto-resume at epoch 1")
    (a_dir, a_shuffles), (b_dir, b_shuffles) = runs["straight"], runs["resumed"]
    check(len(a_shuffles) == len(b_shuffles) == 2 * steps_an_epoch,
          f"{len(a_shuffles)} and {len(b_shuffles)} host shuffles, expected "
          f"{2 * steps_an_epoch} each")
    check(a_shuffles == b_shuffles, "the resumed run's host shuffles differ from the straight "
                                    "run's")
    shuffled_a_batch = [float(n) for _, _, n in a_shuffles]
    check(0 < sum(shuffled_a_batch) < len(a_shuffles) * cfg.TRAIN.ST_BATCH_SIZE,
          f"shuffled stories a batch {shuffled_a_batch}: all or none")
    records = {}
    for label, run_dir in (("straight", a_dir), ("resumed", b_dir)):
        rows = [json.loads(line) for line in (run_dir / "log" / "metrics.jsonl").open()]
        records[label] = {(r["tag"], r["step"]): r["value"] for r in rows
                          if not r["tag"].startswith("perf/")}
    a, b = records["straight"], records["resumed"]
    tags = {tag for tag, _ in a}
    want = set(CASCADE_TAGS) - set(CASCADE_G_TAGS) - {"perf/frames_per_sec", "perf/epoch_seconds"}
    check(tags == want, f"seq CLI tags: missing {want - tags}, extra {tags - want}")
    check(set(a) == set(b), "the straight and resumed runs logged different (tag, step)s")
    check(all(np.isfinite(v) for v in a.values()), "the seq CLI logged a non-finite value")
    order = [v for (tag, _), v in a.items() if tag == "st_D/order"]
    check(len(order) == 2 * steps_an_epoch and all(v > 0 for v in order),
          f"st_D/order {order}: expected one positive order BCE a step")
    worst = max(abs(a[k] - b[k]) / (abs(a[k]) + 1e-6) for k in a)
    check(worst <= 1e-4, f"the resumed epoch's metrics differ from the straight run's by {worst}")
    steps = 4 * steps_an_epoch  # 2 epochs in each run
    expected = {k: v * steps for k, v in per_step.items()}
    expected["dfn_forward"] += 4  # a sample grid an epoch
    check(counts == expected, f"seq CLI: launches {counts}, expected {expected}")
    print(f"seq CLI [{card}]: 2 epochs straight, and 1 + an auto-resumed 1: {len(a_shuffles)} host "
          f"shuffles each, the same bits, {shuffled_a_batch} stories shuffled; metrics (tag, step) {len(a)}, largest relative "
          f"difference {worst:.3e} ({'bitwise' if a == b else 'not bitwise'}); st_D/order "
          + ", ".join(f"{v:.4f}" for v in order) + f"; launches {counts}; {seconds:.2f} s in all")
    for label in runs:
        shutil.rmtree(root / f"seq_cli_{label}")
    return counts


def variant_phases(card: str, gen, seed: int, build_dir: Path) -> types.SimpleNamespace:
    """Phases 21-24 (the module docstring), in a temporary directory under
    `build_dir`. Returns the variants' phase 6 records (`runs`, by file),
    phase 23's `new_maps`, and the launches of the seq CLI, the no-seg CLI
    and its serving."""
    import numpy as np
    import torch

    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.evaluation.drivers import Infer

    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_", dir=build_dir) as tmp:
        variants = write_variants(Path(tmp))
        runs_var = {}
        for fname in ("final_seq.yml", "final_infonce.yml", "final_noseg.yml", "throughput_seq.yml"):
            bf16 = fname == "throughput_seq.yml"
            phase(f"{22 if bf16 else 21}. training at full width{' at bfloat16' if bf16 else ''}, "
                  f"{fname}: {dict(next(v[2] for v in VARIANTS if v[0] == fname))}")
            run = train_at_full_width(variants[fname], seed, card)
            frames = run.cfg.TRAIN.ST_BATCH_SIZE * run.cfg.VIDEO_LEN + run.cfg.TRAIN.IM_BATCH_SIZE
            print(f"{fname} D+G step [{card}]: {run.step_ms:.2f} ms median, "
                  f"{frames / run.step_ms * 1e3:.1f} frames/s ({frames} frames a step); launches a "
                  f"step {run.expected}")
            phase(f"{22 if bf16 else 21}. one D+G step of {fname}, kernels vs plain versions")
            twin_step(run, seed)
            runs_var[fname] = types.SimpleNamespace(
                cfg=run.cfg, expected=run.expected, step_calls=run.step_calls,
                train_counts=run.train_counts, step_ms=run.step_ms, busy_ms=run.busy_ms)
            del run
            torch.cuda.empty_cache()
        phase("23. BN kernels at the variants' new largest maps: the InfoNCE head's B² rows, "
              "the VideoEncoder's stem")
        new_maps = bn_new_maps(gen, card)
        phase(f"24. the variants through the CLI: final_seq.yml --synthetic {CLI_SYNTHETIC}, 2 "
              "epochs and an auto-resumed epoch; final_noseg.yml, one epoch, served")
        seq_counts = seq_cli(card, variants["final_seq.yml"], runs_var["final_seq.yml"].expected,
                             seed, Path(tmp))
        noseg = runs_var["final_noseg.yml"]
        noseg_tags = (set(CASCADE_TAGS) - set(CASCADE_G_TAGS)
                      - {"seg_D/loss", "seg_D/real", "seg_D/fake", "Accuracy/se_D"})
        noseg_counts, noseg_dir = cli_epoch(
            card, variants["final_noseg.yml"], ["--synthetic", str(CLI_SYNTHETIC)],
            noseg.expected, None, noseg_tags, seed, Path(tmp))
        infer = Infer(noseg.cfg, device="cuda", output_dir=str(noseg_dir), seed=seed,
                      load_ckpt=1)
        batch = next(story_batches(SyntheticStoryDataset(STORY_SIZES[0], seed=seed),
                                   STORY_SIZES[0]))
        reset_counts()  # the main path: the entry point only
        video, mask = infer.sample_videos_np(batch, seg=True)
        served = read_counts()
        check(video.shape == (STORY_SIZES[0], noseg.cfg.VIDEO_LEN, 64, 64, 3) and mask is None
              and bool(np.isfinite(video).all() and (np.abs(video) <= 1).all()),
              f"final_noseg.yml served {video.shape}, mask {mask is not None}, frames finite in "
              "[-1, 1] expected")
        check(served == {"dfn_forward": 1, "dfn_backward": 0, "bn_stats": 0, "bn_grad_reduce": 0},
              f"serving final_noseg.yml launched {served}")
        print(f"final_noseg.yml's epoch-1 snapshot through Infer [{card}]: {video.shape}, no mask, "
              f"|frame| mean {abs(video).mean():.4f} max {abs(video).max():.4f}; {served}")
        del infer
    return types.SimpleNamespace(runs=runs_var, new_maps=new_maps, seq_counts=seq_counts,
                                 noseg_counts=noseg_counts, served=served)


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
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.ops.cuda import build
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import (
        dynamic_filter_conv1d_backward_plain,
        dynamic_filter_conv1d_plain,
    )

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
          f"{time.perf_counter() - t0:.2f} s [{card}]")
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
    # bfloat16, as the G step at COMPUTE_DTYPE bfloat16 hands it over: the
    # kernel sums in float32 and rounds each gradient to bfloat16 once, so it
    # lies within one rounding step (2^-8) of the plain backward on the
    # upcast inputs, plus 1e-5 of the magnitude for the order of the sums
    bwd_err_bf16 = 0.0
    for B, (K, pad), offset in itertools.product(KERNEL_BATCHES, TAPS, (0, 1)):
        L_out = L + 2 * pad - K + 1
        img = offset_copy(torch.randn(B, C, L, generator=gen, device="cuda").bfloat16(), offset)
        filt = offset_copy(torch.randn(B, 1, C, K, generator=gen, device="cuda").bfloat16(),
                           offset)
        strided = torch.randn(B, ZMC_WIDTH, generator=gen, device="cuda").bfloat16()[
            :, -L_out:].unsqueeze(1)
        got = dfn_cuda.dfn_backward(img, filt, strided, pad)
        with float32_math():
            ref = dynamic_filter_conv1d_backward_plain(img.float(), filt.float(),
                                                       strided.float(), pad)
        where = f"dfn backward bfloat16 B={B} K={K} pad={pad} offset {offset}"
        for a, r in zip(got, ref):
            err = (a.float() - r).abs()
            scale = r.abs().max().item()
            check(a.dtype == torch.bfloat16 and a.shape == r.shape
                  and bool((err <= 2 ** -8 * r.abs() + 1e-5 * scale).all()),
                  f"{where}: kernel vs plain max error {err.max().item()}")
            bwd_err_bf16 = max(bwd_err_bf16, err.max().item())
        for again in (dfn_cuda.dfn_backward(img, filt, strided, pad),
                      dfn_cuda.dfn_backward(img, filt, strided.contiguous(), pad)):
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"{where}: two launches, or strided and contiguous dout, differ")
    print(f"dfn backward kernel vs the plain version, bfloat16, B in {KERNEL_BATCHES}, K/pad in "
          f"{TAPS}, rows aligned and one element off, dout with row stride {ZMC_WIDTH}: max abs "
          f"error {bwd_err_bf16:.3e} (tol 2^-8·|ref| + 1e-5·max|ref|); two launches, and a "
          "contiguous dout, give the same bits")

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
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
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

    # ------------------------------------------ 15. serving at bfloat16
    phase("15. serving at bfloat16: throughput.yml and procedural.yml through Infer")
    serving_bf16 = bf16_serving(card, args.seed)

    # ----------------------- 6-7. training at full width, each config in turn
    runs = {}
    for name in TRAIN_CONFIGS:
        phase(f"6. training at full width, {name}")
        run = train_at_full_width(name, args.seed, card)
        phase(f"7. one D+G step of {name}, kernels vs plain versions")
        twin_step(run, args.seed)
        # keep what phases 8-10 read; free the state before the next config
        runs[name] = types.SimpleNamespace(expected=run.expected, step_calls=run.step_calls,
                                           train_counts=run.train_counts, step_ms=run.step_ms,
                                           busy_ms=run.busy_ms)
        del run
        torch.cuda.empty_cache()
    bn_shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                              for r in runs.values()))
    train_counts = {k: sum(r.train_counts[k] for r in runs.values()) for k in read_counts()}

    # ----------------- 16-17. training at bfloat16, each config in turn
    runs_bf16, lowering_step_ms = {}, {}
    for name in BF16_CONFIGS:
        phase(f"16. training at bfloat16, {name}")
        run = train_at_full_width(name, args.seed, card)
        frames = run.cfg.TRAIN.ST_BATCH_SIZE * run.cfg.VIDEO_LEN + run.cfg.TRAIN.IM_BATCH_SIZE
        print(f"{name} D+G step at bfloat16 [{card}]: {run.step_ms:.2f} ms median, "
              f"{frames / run.step_ms * 1e3:.1f} frames/s ({frames} frames a step)")
        lowering_step_ms[name] = lowering_steps(run, card)
        phase(f"17. one D+G step of {name} at bfloat16, kernels vs plain versions")
        twin_step(run, args.seed)
        runs_bf16[name] = types.SimpleNamespace(
            expected=run.expected, step_calls=run.step_calls, train_counts=run.train_counts,
            step_ms=run.step_ms, busy_ms=run.busy_ms)
        del run
        torch.cuda.empty_cache()
    bf16_shapes = set().union(*(set(r.step_calls["bn_stats"]) | set(r.step_calls["bn_grad_reduce"])
                                for r in runs_bf16.values()))
    bf16_counts = {k: sum(r.train_counts[k] for r in runs_bf16.values()) for k in read_counts()}

    # ---------------------------------- 18. the four lowerings side by side
    phase("18. FUSED_UPSAMPLE off, deconv, parity4, parity1 at bfloat16")
    for name in BF16_CONFIGS:
        print(f"{name} [{card}]: " + "; ".join(
            f"{k}: serving {serving_bf16['lowering_ms'][name][k]:.2f} ms a call of "
            f"{STORY_SIZES[-1]} stories, D+G step {lowering_step_ms[name][k]:.2f} ms"
            for k in lowering_step_ms[name]))
    # ------------------------- 8. BN kernels vs plain at the step's shapes
    phase("8. BN kernels vs plain")
    shapes = (sorted(bn_shapes) + sorted({(7, c, sp) for _, c, sp in bn_shapes})
              + list(EDGE_BN_SHAPES))
    bn_err, plans = bn_vs_plain(gen, shapes, torch.float32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"BN kernels vs plain on the card at {len(shapes)} shapes (N, C, S), each aligned "
          f"and one float off: the step's {sorted(bn_shapes)}, N=7, and {EDGE_BN_SHAPES}: "
          f"max abs error bn_stats {bn_err['bn_stats']:.3e}, bn_grad_reduce "
          f"{bn_err['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' magnitude + 1e-6); two "
          f"launches give the same bits; plans (kernel, vec, cluster, channels a block) on "
          f"{sms} SMs: {sorted(plans)}")
    # bfloat16 x and dy at the bfloat16 steps' shapes: against the plain
    # versions, which sum the same values in float32
    shapes = (sorted(bf16_shapes) + sorted({(7, c, sp) for _, c, sp in bf16_shapes})
              + list(EDGE_BN_SHAPES))
    bn_err_bf16, plans = bn_vs_plain(gen, shapes, torch.bfloat16)
    check({v for _, v, _, _ in plans} == {1, 8}, f"bfloat16 plans {sorted(plans)}")
    print(f"BN kernels vs plain on the card, bfloat16, at {len(shapes)} shapes (N, C, S), each "
          f"aligned and one element off: the bfloat16 steps' {sorted(bf16_shapes)}, N=7, and "
          f"{EDGE_BN_SHAPES}: max abs error bn_stats {bn_err_bf16['bn_stats']:.3e}, "
          f"bn_grad_reduce {bn_err_bf16['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' "
          f"magnitude + 1e-6); two launches give the same bits; plans: {sorted(plans)}")

    # ------------------------------------------------ 9. new kernels' times
    phase("9. kernel timings: the BN reductions at every shape of the step, the DFN backward")

    per_shape, step_bn = bn_timings(gen, card, runs, torch.float32)
    largest = bn_largest(gen, card, runs, per_shape, torch.float32)
    for name in ("bn_stats", "bn_grad_reduce"):
        _, _, kernel_ms, library_ms, bound = per_shape[name, largest[name]["shape"]]
        kernels[name] = {
            "name": name, "route": "cuda", "source": bn_cuda.SOURCE,
            "replaces": bn_cuda.REPLACES[name], "launches": train_counts[name],
            "max_abs_err": bn_err[name], "ms": kernel_ms, "plain_ms": largest[name]["plain_ms"],
            "bound_ms": bound, "bound_by": largest[name]["bound_by"], "library_ms": library_ms,
            "step_ms": step_bn["final.yml"][name][0],
            "step_bound_ms": step_bn["final.yml"][name][2],
            "cascade_step_ms": step_bn["cascade.yml"][name][0],
            "cascade_step_bound_ms": step_bn["cascade.yml"][name][2],
        }
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
    # bfloat16: the BN kernels at every shape of the bfloat16 steps, their
    # largest; the DFN pair at throughput.yml's IM_BATCH (360) and
    # procedural.yml's (90)
    per_shape_bf16, step_bn_bf16 = bn_timings(gen, card, runs_bf16, torch.bfloat16)
    largest_bf16 = bn_largest(gen, card, runs_bf16, per_shape_bf16, torch.bfloat16)
    for name in ("bn_stats", "bn_grad_reduce"):
        shape = largest_bf16[name]["shape"]
        _, _, kernel_ms, library_ms, bound = per_shape_bf16[name, shape]
        kernels[name].update({
            "bf16_launches": bf16_counts[name], "bf16_shape": shape,
            "bf16_max_abs_err": bn_err_bf16[name], "bf16_ms": kernel_ms,
            "bf16_plain_ms": largest_bf16[name]["plain_ms"], "bf16_bound_ms": bound,
            "bf16_bound_by": largest_bf16[name]["bound_by"], "bf16_library_ms": library_ms,
            **{f"{c.split('.')[0]}_step_{k}": step_bn_bf16[c][name][i]
               for c in BF16_CONFIGS for i, k in ((0, "ms"), (2, "bound_ms"))},
        })
    bwd16, bwd16_op, _, copies16 = dfn_backward_times(gen, card, floor, torch.bfloat16, (360, 90))
    check(copies16 == 0,
          f"the bfloat16 DFN backward op copied a row-strided dout {copies16} times")
    fwd16 = dfn_forward_times(gen, card, floor, torch.bfloat16, (360,))
    for name, t, err in (("dfn_forward", fwd16[360], max_err[torch.bfloat16]),
                         ("dfn_backward", bwd16[360], bwd_err_bf16)):
        kernels[name].update({
            "bf16_launches": bf16_counts[name], "bf16_shape": [360, *DFN_SHAPE[:2]],
            "bf16_max_abs_err": err, "bf16_ms": t.graph_ms, "bf16_plain_ms": t.plain_ms,
            "bf16_bound_ms": t.bound_ms, "bf16_bound_by": t.bound_by,
            "bf16_library_ms": t.library_ms})
    kernels["dfn_forward"]["bf16_launches"] += serving_bf16["launches"]

    # -------------------------------------- 10. the trainer through the CLI
    phase("10. the trainer through the CLI: cascade.yml, one epoch, then auto-resume")
    cli_counts = cli_trainer(card, runs["cascade.yml"].expected, args.seed)
    build_dir = REPO / "build"
    build_dir.mkdir(exist_ok=True)

    # ------------------------------- 19. throughput.yml through the CLI
    phase(f"19. throughput.yml --synthetic {THROUGHPUT_SYNTHETIC} through the CLI, one epoch at "
          "bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_", dir=build_dir) as tmp:
        cli_bf16, _ = cli_epoch(card, "throughput.yml",
                                ["--synthetic", str(THROUGHPUT_SYNTHETIC)],
                                runs_bf16["throughput.yml"].expected, 2,
                                set(CASCADE_TAGS) - set(CASCADE_G_TAGS), args.seed, Path(tmp))
    for name in kernels:
        bf16 = bf16_counts[name] + cli_bf16[name]
        kernels[name]["bf16_launches"] += cli_bf16[name]
        if name == "dfn_forward":
            kernels[name]["launches"] += (train_counts[name] + cli_counts[name] + bf16
                                          + serving_bf16["launches"])
        else:
            kernels[name]["launches"] = train_counts[name] + cli_counts[name] + bf16

    # -------------------------- 11-12. from disk, then the checkpoint walks
    with tempfile.TemporaryDirectory(prefix="chip_smoke_disk_", dir=build_dir) as tmp:
        phase("11. cascade.yml from a procedural Pororo tree on disk through the CLI, 2 epochs")
        disk_counts, run_dir, data_dir = disk_trainer(card, runs["cascade.yml"].expected,
                                                      runs["cascade.yml"], args.seed, Path(tmp))
        phase("12. the checkpoint walks: --eval_fid, --eval_ssim, --load_ckpt")
        walk_counts = walks(card, run_dir, data_dir, args.seed)
        phase("13. the FVD and IS walks: --eval_fvd (R(2+1)D, then a seeded I3D file), --eval_is")
        fvd_is_counts = fvd_is_walks(card, run_dir, data_dir, args.seed, Path(tmp))
        phase("14. rehearsal.yml through the CLI, 2 epochs with the in-training FID/FSD")
        rehearsal_counts = rehearsal_trainer(card, runs["cascade.yml"].expected, args.seed,
                                             Path(tmp))
        phase("20. procedural.yml --data_dir on phase 11's tree through the CLI, one epoch at "
              "bfloat16")
        procedural_counts, _ = cli_epoch(card, "procedural.yml", ["--data_dir", str(data_dir)],
                                         runs_bf16["procedural.yml"].expected, None,
                                         set(CASCADE_TAGS), args.seed, Path(tmp))
    for name in kernels:
        kernels[name]["launches"] += (disk_counts[name] + walk_counts[name]
                                      + fvd_is_counts[name] + rehearsal_counts[name]
                                      + procedural_counts[name])
        kernels[name]["bf16_launches"] += procedural_counts[name]
    print(f"launches on the main paths: serving {launches} dfn_forward; the steps of "
          f"{', '.join(runs)} {train_counts}; the CLI {cli_counts}; from disk {disk_counts}; "
          f"the walks {walk_counts}; FVD and IS {fvd_is_counts}; rehearsal {rehearsal_counts}; "
          f"at bfloat16: serving {serving_bf16['launches']} dfn_forward, the steps of "
          f"{', '.join(runs_bf16)} {bf16_counts}, throughput.yml's CLI {cli_bf16}, "
          f"procedural.yml's CLI {procedural_counts}")

    # -------------- 21-24. the remaining training objectives, as variants
    variants = variant_phases(card, gen, args.seed, build_dir)
    runs_var, served = variants.runs, variants.served
    for name in kernels:
        f32_var = sum(r.train_counts[name] for f, r in runs_var.items()
                      if f != "throughput_seq.yml")
        bf16_var = runs_var["throughput_seq.yml"].train_counts[name]
        kernels[name]["launches"] += (f32_var + bf16_var + variants.seq_counts[name]
                                      + variants.noseg_counts[name] + served[name])
        kernels[name]["bf16_launches"] += bf16_var
        kernels[name]["variant_step_launches"] = {f: r.expected[name]
                                                  for f, r in runs_var.items()}
    for name, rows in variants.new_maps.items():
        kernels[name]["new_maps"] = rows
    print(f"launches of the variants: the steps "
          + "; ".join(f"{f} {r.train_counts}" for f, r in runs_var.items())
          + f"; the seq CLI {variants.seq_counts}; the no-seg CLI {variants.noseg_counts}; its "
          f"serving {served}")

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
