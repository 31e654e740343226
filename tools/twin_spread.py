#!/usr/bin/env python3
"""Read the spread of chip_smoke.py's phase 7 over seeds, on one NVIDIA GPU.

    python3 tools/twin_spread.py [--config clevr.yml] [--seeds 0 1 2 ...]

Drives the PyTorch/CUDA port (cpcsv_tpu_torch) only. Builds the kernels as
chip_smoke.py's phase 2 does, then for each seed runs phase 6 of the config
(a fresh state from the seed and 7 D+G steps) and phase 7 on its state with
the yardstick on: the kernels-vs-plain spread of one D+G step and the
largest spread of the ten pairs among the plain step and its four reordered
twins. Prints one JSON line per seed and a summary; holds no tolerance, so
that every seed is read. The readings decide phase 7's float32 tolerances
for the configs in chip_smoke.F32_YARDSTICK.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", default="clevr.yml")
    parser.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("twin_spread: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from cpcsv_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = True  # as chip_smoke.py's main
    torch.backends.cuda.matmul.allow_tf32 = True
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        list(pool.map(build.build, build.SOURCES))
    for name in build.SOURCES:
        build.load(name)

    keys = ("metric", "accuracy", "gradient", "zero_gradient", "bn_statistics")
    rows = []
    for seed in args.seeds:
        run = chip_smoke.train_at_full_width(args.config, seed, card)
        read = chip_smoke.twin_step(run, seed, hold=False)
        del run
        torch.cuda.empty_cache()
        row = {"config": args.config, "seed": seed, "card": card}
        for part in ("kernels_vs_plain", "yardstick", "tolerances"):
            row[part] = dict(zip(keys, read[part])) if read[part] else None
        rows.append(row)
        print(json.dumps(row), flush=True)
    for key in keys:
        kern = [r["kernels_vs_plain"][key] for r in rows]
        yard = [r["yardstick"][key] for r in rows if r["yardstick"]]
        print(f"{args.config} {key} over {len(rows)} seeds [{card}]: kernels vs plain "
              f"{min(kern):.3e}-{max(kern):.3e}"
              + (f", plain pairs' largest spread {min(yard):.3e}-{max(yard):.3e}"
                 if yard else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
