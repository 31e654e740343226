#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cpcsv_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which exits non-zero on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build every CUDA kernel from the sources in this checkout with nvcc
     into build/kernels/;
  3. each kernel against its plain PyTorch version on the card;
  4. story generation at full width, configs final.yml (v1) and cascade.yml,
     through the serving entry point `Infer` with random weights from --seed:
     shapes, finite values in [-1, 1], the kernels' launch counts, the same
     frames through the plain DFN, float32 inside the entry point while
     TF32 is allowed globally, and a `generate_story` PNG walk;
  5. timings on the card: the slice's frames/s and its device busy time
     from a torch.profiler trace; each kernel's device time from a trace,
     and at the main path's batch in one CUDA graph, beside its bound, its
     plain version and one PyTorch library call.
The line before the last is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
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
TAPS = ((21, 10), (7, 3))  # (K, pad)


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


def random_generator_state(cfg, stories, seed: int):
    """A full-width generator state_dict: reference init (convs and dense
    N(0, 0.02), BN scale N(1, 0.02), biases 0; GRUs keep torch's default)
    from `seed`, then BN running statistics set from one forward pass on the
    card, each mean shifted and each variance scaled at random, so eval BN
    is far from the identity and the activations keep a useful range."""
    import torch

    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import _batch_motion_content
    from cpcsv_tpu_torch.models.factory import generator_from_config

    torch.manual_seed(seed)
    net = generator_from_config(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
                mod.weight.normal_(0.0, 0.02, generator=g)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                mod.weight.normal_(1.0, 0.02, generator=g)
                mod.bias.zero_()
    net.cuda().eval()
    gc = torch.Generator(device="cuda").manual_seed(seed)

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
    from cpcsv_tpu_torch.data.synthetic import SyntheticStoryDataset, story_batches
    from cpcsv_tpu_torch.device import float32_math
    from cpcsv_tpu_torch.evaluation.drivers import Infer
    from cpcsv_tpu_torch.models import generator as generator_module
    from cpcsv_tpu_torch.ops.cuda import build
    from cpcsv_tpu_torch.ops.cuda import dfn as dfn_cuda
    from cpcsv_tpu_torch.ops.dynamic_filter import dynamic_filter_conv1d_plain

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
    log = build.build("dfn")
    build.load("dfn")
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  nvcc dfn: {line.strip()}")

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

            dfn_cuda.launches = 0  # the main path: entry points only
            for n, batch in batches.items():
                rng_states[n] = infer.generator.get_state()
                videos[n], _ = infer.sample_videos_np(batch)
            _, gen_dir = infer.generate_story(
                story_batches(SyntheticStoryDataset(STORY_SIZES[0], seed=args.seed),
                              STORY_SIZES[0]))
            count = dfn_cuda.launches
            hook.remove()
            calls = len(batches) + 1
            check(count == calls,
                  f"{name}: dfn kernel launched {count} times in {calls} generator calls")
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
    kernels = [{
        "name": "dfn_forward",
        "route": "cuda",
        "source": "cpcsv_tpu_torch/csrc/dfn.cu",
        "replaces": dfn_cuda.REPLACES,
        "launches": launches,
        "max_abs_err": max_err[torch.float32],
        "ms": graphed["kernel"],
        "plain_ms": graphed["plain"],
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": graphed["library"],
    }]
    phase("done")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
