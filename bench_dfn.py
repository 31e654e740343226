#!/usr/bin/env python3
"""Time the dynamic-filter kernels of a checkout (cpcsv_tpu_torch/csrc/dfn.cu)
at the shapes of the generator's main paths, on one NVIDIA GPU.

    python3 bench_dfn.py [--tree DIR] [--seed N]

DIR (default: this checkout) is a checkout of the repository whose
`cpcsv_tpu_torch` is built and timed; the timing code is this checkout's
`chip_smoke.py` (phases 5 and 9). Prints the card, the launch floor (an empty
kernel in one CUDA graph), the forward at B = 90, 360 and 1440 and the
backward at B = 90 and 7, each in one CUDA graph and from a trace, over the floor and
against its bound, its plain version and its library call, the backward op
of the G step on its row-strided dout with whatever copy the op makes, and
the pair's time over one D+G step. Two versions compare within one call, in
turns: parent, change, change, parent. Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", type=Path, default=cs.REPO)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA device: the DFN kernels run on an NVIDIA GPU")
    if not (args.tree / "cpcsv_tpu_torch" / "csrc" / "dfn.cu").is_file():
        cs.fail(f"{args.tree} is not a checkout of the repository")
    sys.path.insert(0, str(args.tree.resolve()))
    from cpcsv_tpu_torch.ops.cuda import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; timing {args.tree.resolve() / 'cpcsv_tpu_torch'}")
    for line in build.build("dfn").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  nvcc dfn: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    floor = cs.launch_floor_ms()
    empty = cs.device_ms(lambda: torch.cuda._sleep(0), "empty kernel")
    print(f"launch floor [{card}]: {floor * 1e3:.2f} us per launch in one CUDA graph "
          f"(torch.cuda._sleep(0), an empty kernel); traced {empty * 1e3:.2f} us")
    fwd = cs.dfn_forward_times(gen, card, floor)
    _, ops, copy_ms, copies = cs.dfn_backward_times(gen, card, floor)
    cs.dfn_step_ms(card, fwd[90], ops[90], copies, copy_ms[90], floor)
    return 0


if __name__ == "__main__":
    sys.exit(main())
