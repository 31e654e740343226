#!/usr/bin/env python3
"""Time the BN reduction kernels (cpcsv_tpu_torch/csrc/bn.cu) under every
launch plan they take, at the map shapes of a final.yml D+G step, on one
NVIDIA GPU.

    python3 sweep_bn.py

One full-width D+G step (IM_BATCH 90 / ST_BATCH 18, random weights) gives
the BN calls by shape, counted as `chip_smoke.py` phase 6 counts them. At
each shape with S > 1, each kernel runs under the plans of 1, 2, 4 or 8
channels a block without a cluster, and of one channel a cluster of 2, 3,
4, 6 or 8 blocks, float4 loads; each is timed as phase 9 times the plan
that `ops/cuda/bn.py:plan` picks: one CUDA graph, inputs L2-cold. Prints
µs per call by plan, the picked plan marked with *, and, over the shapes,
each plan's sum weighted by the step's launches. This is the measurement
behind `plan`'s BLOCKS_PER_SM and its clusters. Without a CUDA device it
exits non-zero.
"""

from __future__ import annotations

import functools
import subprocess
import sys

import chip_smoke as cs

LAYOUTS = [(cpb, 1) for cpb in (8, 4, 2, 1)] + [(1, q) for q in (2, 3, 4, 6, 8)]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the BN kernels run on an NVIDIA GPU")
    from cpcsv_tpu_torch.config import config_from_file
    from cpcsv_tpu_torch.data.synthetic import synthetic_batches
    from cpcsv_tpu_torch.ops.cuda import bn as bn_cuda
    from cpcsv_tpu_torch.train.state import create_train_state
    from cpcsv_tpu_torch.train.steps import batch_to_device, make_train_steps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cfg = config_from_file("final.yml")
    state = create_train_state(cfg, 0)
    batches = [batch_to_device(b, torch.device("cuda")) for b in synthetic_batches(
        cfg, cfg.TRAIN.ST_BATCH_SIZE, cfg.TRAIN.IM_BATCH_SIZE, 0)]
    d_step, g_step = make_train_steps(cfg)
    rng = torch.Generator(device="cuda").manual_seed(0)
    with cs.counting_bn_calls() as step_calls:
        d_step(state, rng, *batches, cs.LR_D)
        g_step(state, rng, *batches, cs.LR_G)
    del state, batches
    torch.cuda.empty_cache()

    print(f"{card}, {sms} SMs; us per call in one CUDA graph, inputs L2-cold; "
          "c<channels a block>q<blocks a cluster>, * = the plan `plan` picks")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, calls in step_calls.items():
        plain = bn_cuda.bn_stats_plain if name == "bn_stats" else bn_cuda.bn_grad_reduce_plain
        totals = dict.fromkeys(LAYOUTS, 0.0)  # sums of launches x us over the shapes
        picked_total = 0.0
        for (N, C, S), n_calls in sorted(calls.items()):
            if S == 1:
                continue
            picked = bn_cuda.plan(N, C, S, sms, True)
            inputs = cs.bn_cold_inputs(gen, name, N, C, S)
            want = plain(*inputs[0])
            times = {}
            for cpb, q in LAYOUTS:
                kernel = functools.partial(bn_cuda.launch, name,
                                           bn_cuda.Plan(4, -(-C // cpb) * q, q, cpb))
                for a, r in zip(kernel(*inputs[0]), want):
                    cs.check(torch.allclose(a, r, rtol=1e-4, atol=1e-2),
                             f"{name} {(N, C, S)} c{cpb}q{q} disagrees with plain")
                times[(cpb, q)] = cs.cold_graph_ms(kernel, inputs) * 1e3
                totals[(cpb, q)] += n_calls * times[(cpb, q)]
            picked_total += n_calls * times[(picked.channels, picked.cluster)]
            bound = cs.bn_bound(name, N, C, S)[0] * 1e3
            print(f"{name} {(N, C, S)} x{n_calls} a step, bound {bound:.2f}: " + " ".join(
                f"c{cpb}q{q}{'*' if (cpb, q) == (picked.channels, picked.cluster) else ''}"
                f"={t:.2f}" for (cpb, q), t in times.items()))
            del inputs
        print(f"{name}, sum of launches x us over the step's map shapes: the picked plans "
              f"{picked_total:.1f}; one layout for all: "
              + " ".join(f"c{cpb}q{q}={t:.1f}" for (cpb, q), t in totals.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
