"""A rank of `cpcsv_tpu_torch.parallel.launch.run_ranks` in
`tests/test_torch_launch.py`, importing nothing heavy, so that a launch of
it takes well under a second: each rank prints a line and writes its pid to
argv[0]/pid{rank}; rank 1 then waits for rank 0's pid file (rank 0 has
printed by then) and exits 3, while rank 0 sleeps, as a rank waiting on its
failed peer would."""

import os
import sys
import time
from pathlib import Path


def main(argv):
    rank = int(os.environ["CPCSV_PROCESS_ID"])
    print(f"rank {rank} of {os.environ['CPCSV_NUM_PROCESSES']} on card "
          f"{os.environ['LOCAL_RANK']}", flush=True)
    staged = Path(argv[0], f"pid{rank}.staged")
    staged.write_text(str(os.getpid()))
    os.replace(staged, Path(argv[0], f"pid{rank}"))  # whole when seen
    if rank == 1:
        deadline = time.monotonic() + 60
        while not Path(argv[0], "pid0").exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        sys.exit(3)
    time.sleep(60)
