#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpcsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout with nvcc
     into build/kernels/ (one nvcc per source), with its register lines;
  3. the DFN kernels, forward and backward, against their plain PyTorch
     versions on the card;
  4. story generation at full width, configs final.yml (v1) and cascade.yml,
     through the serving entry point `Infer` with random weights from --seed:
     shapes, finite values in [-1, 1], the kernels' launch counts, the same
     frames through the plain DFN, float32 inside the entry point while
     TF32 is allowed globally, and a `generate_story` PNG walk;
  5. serving timings: frames/s and device busy time from a torch.profiler
     trace; the DFN forward kernel's device time from a trace and in one
     CUDA graph, beside its bound, its plain version and a library call;
  6. training at full width, final.yml at IM_BATCH 90 / ST_BATCH 18, from
     `create_train_state` through `make_train_steps`: 2 warm-up and 5 timed
     D+G steps with finite metrics, every parameter, BN running statistic
     and SN u moved, each kernel's launches equal to the per-step count
     derived from the code times the steps, float32 inside the steps; ms per
     step, steps/s, device busy time and idle share from a trace, peak memory;
  7. from one saved state and the same noise, one D+G step with the kernels
     against one with their plain versions swapped in: losses, gradients and
     BN running statistics;
  8. the BN kernels against their plain versions at every (N, C, S) the
     step gave them, and at an odd N;
  9. the new kernels' times at the step's largest shape and a small one.
The line before the last is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
STORY_SIZES = (18, 72)  # stories per call; 5 frames each
KERNEL_BATCHES = (1, 7, 90, 360, 1440)
BACKWARD_BATCHES = (1, 7, 90, 1440)
TAPS = ((21, 10), (7, 3))  # (K, pad)
LR_D, LR_G = 4e-4, 1e-4  # final.yml's DISCRIMINATOR_LR, GENERATOR_LR
WARMUP_STEPS, TIMED_STEPS = 2, 5


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

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    check(bool(dev), "torch.profiler recorded no device activity")
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
    """Mean milliseconds per call of `reps` calls captured in one CUDA graph
    and replayed: no host work between launches and no profiler. Used at
    B=90 only: a grouped cuDNN conv1d hung in capture at B >= 360."""
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
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
        "dfn_forward": 4,
        "dfn_backward": 2,
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
    import torch.nn.functional as F

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
    for name in build.SOURCES:
        t0 = time.perf_counter()
        log = build.build(name)
        build.load(name)
        print(f"build {name}: {time.perf_counter() - t0:.2f} s")
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  nvcc {name}: {line.strip()}")

    # ---------------------------------------------------- 3. kernel vs plain
    phase("3. kernel vs plain")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    C, L = 3, 124
    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        # float32: the taps are summed in another order; bfloat16: the kernel
        # accumulates in float32 and rounds its output to bfloat16 once
        tol = 1e-5 if dtype == torch.float32 else 1e-2
        for B in KERNEL_BATCHES:
            for K, pad in TAPS:
                img = torch.randn(B, C, L, generator=gen, device="cuda").to(dtype)
                filt = torch.randn(B, 1, C, K, generator=gen, device="cuda").to(dtype)
                out = dfn_cuda.dfn_forward(img, filt, pad)
                with float32_math():
                    ref = dynamic_filter_conv1d_plain(img.float(), filt.float(), pad)
                check(out.dtype == dtype and out.shape == ref.shape,
                      f"dfn {dtype} B={B} K={K}: {out.dtype} {tuple(out.shape)}")
                err = (out.float() - ref).abs()
                check(bool((err <= tol + tol * ref.abs()).all()),
                      f"dfn kernel vs plain, {dtype} B={B} K={K}: max error {err.max().item()}")
                max_err[dtype] = max(max_err[dtype], err.max().item())
    print(f"dfn kernel vs plain on the card, B in {KERNEL_BATCHES}, K/pad in {TAPS}: "
          f"max abs error f32 {max_err[torch.float32]:.3e} (tol 1e-5), "
          f"bf16 {max_err[torch.bfloat16]:.3e} (tol 1e-2)")
    # the backward against autograd of the plain version; float32, the sums
    # (up to 124 products) run in another order: 1e-5 + 1e-5·|ref|
    bwd_err = 0.0
    for B in BACKWARD_BATCHES:
        for K, pad in TAPS:
            img = torch.randn(B, C, L, generator=gen, device="cuda")
            filt = torch.randn(B, 1, C, K, generator=gen, device="cuda")
            dout = torch.randn(B, 1, L + 2 * pad - K + 1, generator=gen, device="cuda")
            got = dfn_cuda.dfn_backward(img, filt, dout, pad)
            with float32_math():
                ref = dynamic_filter_conv1d_backward_plain(img, filt, dout, pad)
            for a, r in zip(got, ref):
                err = (a - r).abs()
                check(a.shape == r.shape and bool((err <= 1e-5 + 1e-5 * r.abs()).all()),
                      f"dfn backward kernel vs plain, B={B} K={K}: max error {err.max().item()}")
                bwd_err = max(bwd_err, err.max().item())
            check(all(torch.equal(a, b) for a, b in zip(got, dfn_cuda.dfn_backward(
                img, filt, dout, pad))), f"dfn backward B={B} K={K}: two launches differ")
    print(f"dfn backward kernel vs autograd of the plain version, B in {BACKWARD_BATCHES}, "
          f"K/pad in {TAPS}: max abs error {bwd_err:.3e} (tol 1e-5 + 1e-5·|ref|); "
          "two launches give the same bits")

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
    for B in (90, 1440):
        K, pad = TAPS[0]
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
            dev = {k: device_ms(f, f"{k} B={B}") for k, f in fns.items()}
            call = {k: event_ms(f) for k, f in fns.items()}
            if B == 90:
                graphed = {k: graph_ms(f) for k, f in fns.items()}
                print(f"dfn B={B} f32 [{card}]: us/call in one CUDA graph "
                      + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in graphed.items()))
        bound, bound_by = dfn_bound(B, C, L, K, pad, 4)
        print(f"dfn B={B} f32 [{card}]: traced device us/call kernel {dev['kernel'] * 1e3:.2f}, "
              f"plain {dev['plain'] * 1e3:.2f}, grouped conv1d {dev['library'] * 1e3:.2f}; "
              f"per call back to back kernel {call['kernel'] * 1e3:.2f}, plain "
              f"{call['plain'] * 1e3:.2f}, grouped conv1d {call['library'] * 1e3:.2f}; "
              f"bound {bound * 1e3:.3f} us ({bound_by})")

    # The main path's shape, 18 stories x 5 frames, timed in one CUDA graph:
    # the trace gives the library's 90 per-group cuDNN kernels about four
    # times the graph's time, so the graph is the figure the line reports.
    bound, bound_by = dfn_bound(90, C, L, *TAPS[0], 4)
    kernels = {"dfn_forward": {
        "name": "dfn_forward",
        "route": "cuda",
        "source": dfn_cuda.SOURCE,
        "replaces": dfn_cuda.REPLACES,
        "launches": launches,
        "max_abs_err": max_err[torch.float32],
        "ms": graphed["kernel"],
        "plain_ms": graphed["plain"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": graphed["library"],
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
    bn_shapes, inside = set(), set()
    record = [m.register_forward_pre_hook(lambda mod, inp: bn_shapes.add(
        (inp[0].shape[0], inp[0].shape[1], inp[0][0, 0].numel())))
        for net in nets.values() for m in bn_modules(net)]
    flags = [mod.register_forward_pre_hook(lambda *_: inside.add(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
        for mod in (state.gen.upsample1, state.d_st.get_cond_logits)]
    expected = per_step_launches(state)
    steps = WARMUP_STEPS + TIMED_STEPS
    times, metrics = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path: the entry points only
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, dm = d_step(state, rng, st_batch, im_batch, LR_D)
        _, gm = g_step(state, rng, st_batch, im_batch, LR_G)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        metrics.append({**dm, **gm})
        if i == 0:  # the shapes are the same every step
            for h in record:
                h.remove()
    train_counts = read_counts()
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
    shapes = sorted(bn_shapes) + sorted({(7, c, sp) for _, c, sp in bn_shapes})
    bn_err = {"bn_stats": 0.0, "bn_grad_reduce": 0.0}
    for N, Cb, S in shapes:
        x = torch.randn(N, Cb, S, generator=gen, device="cuda") + 0.5
        dy = torch.randn(N, Cb, S, generator=gen, device="cuda")
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
                check(torch.equal(a, b), f"{name} {(N, Cb, S)}: two launches differ")
                check(bool((err <= 1e-5 * mag + 1e-6).all()),
                      f"{name} {(N, Cb, S)}: kernel vs plain error {err.max().item()}")
                bn_err[name] = max(bn_err[name], err.max().item())
    print(f"BN kernels vs plain on the card at {len(shapes)} shapes (N, C, S), the step's "
          f"{sorted(bn_shapes)} and N=7: max abs error bn_stats {bn_err['bn_stats']:.3e}, "
          f"bn_grad_reduce {bn_err['bn_grad_reduce']:.3e} (tol 1e-5 of the terms' magnitude "
          "+ 1e-6); two launches give the same bits")

    # ------------------------------------------------ 9. new kernels' times
    phase("9. kernel timings: BN reductions and the DFN backward")
    largest = max(bn_shapes, key=lambda sh: sh[0] * sh[1] * sh[2])
    smallest = min(bn_shapes, key=lambda sh: sh[0] * sh[1] * sh[2])
    for N, Cb, S in (largest, smallest):
        x = torch.randn(N, Cb, S, generator=gen, device="cuda")
        dy = torch.randn(N, Cb, S, generator=gen, device="cuda")
        mean = x.mean(dim=(0, 2))
        inv = torch.rsqrt(x.var(dim=(0, 2), correction=0) + 1e-5)
        ones = torch.ones(Cb, device="cuda")
        fns = {
            "bn_stats": {
                "kernel": lambda: bn_cuda.bn_stats(x),
                "plain": lambda: bn_cuda.bn_stats_plain(x),
                "library": lambda: torch.var_mean(x, dim=(0, 2), correction=0),
            },
            "bn_grad_reduce": {
                "kernel": lambda: bn_cuda.bn_grad_reduce(x, dy, mean, inv),
                "plain": lambda: bn_cuda.bn_grad_reduce_plain(x, dy, mean, inv),
                "library": lambda: torch.ops.aten.native_batch_norm_backward(
                    dy, x, ones, None, None, mean, inv, True, 1e-5, [False, True, True]),
            },
        }
        lib = fns["bn_grad_reduce"]["library"]()
        got = bn_cuda.bn_grad_reduce(x, dy, mean, inv)
        check(torch.allclose(lib[2], got[0], rtol=1e-4, atol=1e-2)
              and torch.allclose(lib[1], got[1], rtol=1e-4, atol=1e-2),
              "native_batch_norm_backward disagrees with bn_grad_reduce")
        for name, f in fns.items():
            graphed = {k: graph_ms(fn) for k, fn in f.items()}
            traced = {k: device_ms(fn, f"{name} {k} {(N, Cb, S)}") for k, fn in f.items()}
            bound, bound_by = bn_bound(name, N, Cb, S)
            print(f"{name} (N, C, S)={(N, Cb, S)} f32 [{card}]: us/call in one CUDA graph "
                  + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in graphed.items())
                  + "; traced " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in traced.items())
                  + f"; bound {bound * 1e3:.3f} us ({bound_by})")
            if (N, Cb, S) == largest:
                kernels[name] = {
                    "name": name, "route": "cuda", "source": bn_cuda.SOURCE,
                    "replaces": bn_cuda.REPLACES[name], "launches": train_counts[name],
                    "max_abs_err": bn_err[name], "ms": graphed["kernel"],
                    "plain_ms": graphed["plain"], "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": graphed["library"],
                }
    K, pad = TAPS[0]
    for B in (90, 7):  # the step's batch, and a small one
        img = torch.randn(B, C, L, generator=gen, device="cuda")
        filt = torch.randn(B, 1, C, K, generator=gen, device="cuda")
        dout = torch.randn(B, 1, L, generator=gen, device="cuda")
        fns = {
            "kernel": lambda: dfn_cuda.dfn_backward(img, filt, dout, pad),
            "plain": lambda: dynamic_filter_conv1d_backward_plain(img, filt, dout, pad),
            "library": lambda: torch.ops.aten.convolution_backward(
                dout.view(1, B, L), img.view(1, B * C, L), filt.view(B, C, K), None, [1],
                [pad], [1], False, [0], B, [True, True, False]),
        }
        with float32_math():
            lib, got = fns["library"](), fns["kernel"]()
            check(torch.allclose(lib[0].view(B, C, L), got[0], rtol=1e-5, atol=1e-4)
                  and torch.allclose(lib[1].view(B, 1, C, K), got[1], rtol=1e-5, atol=1e-4),
                  "grouped conv1d backward disagrees with dfn_backward")
            traced = {k: device_ms(f, f"dfn_backward {k} B={B}") for k, f in fns.items()}
            graphed = {k: graph_ms(f) for k, f in fns.items()}
        bound, bound_by = dfn_backward_bound(B, C, L, K, pad)
        print(f"dfn_backward B={B} f32 [{card}]: us/call in one CUDA graph "
              + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in graphed.items())
              + "; traced " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in traced.items())
              + f"; bound {bound * 1e3:.3f} us ({bound_by})")
        if B == 90:
            kernels["dfn_backward"] = {
                "name": "dfn_backward", "route": "cuda", "source": dfn_cuda.SOURCE,
                "replaces": dfn_cuda.REPLACES_BACKWARD, "launches": train_counts["dfn_backward"],
                "max_abs_err": bwd_err, "ms": graphed["kernel"], "plain_ms": graphed["plain"],
                "bound_ms": bound, "bound_by": bound_by, "library_ms": graphed["library"],
            }
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
