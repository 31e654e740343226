"""A rank of `cpcsv_tpu_torch.parallel.launch.run_ranks` in
`tests/test_torch_launch.py` and `tests/test_torch_hosts.py`, importing
nothing heavy, so that a launch of it takes well under a second: each rank
(CPCSV_PROCESS_ID × LOCAL_WORLD_SIZE + LOCAL_RANK of CPCSV_NUM_PROCESSES ×
LOCAL_WORLD_SIZE) prints a line and writes its pid to argv[0]/pid{rank};
rank argv[1] (default 1) then waits for rank 0's pid file (rank 0 has
printed by then) and exits 3, while the others sleep, as ranks waiting on
their failed peer would."""

import os
import sys
import time
from pathlib import Path


def main(argv):
    per_host = int(os.environ["LOCAL_WORLD_SIZE"])
    rank = int(os.environ["CPCSV_PROCESS_ID"]) * per_host + int(os.environ["LOCAL_RANK"])
    world = int(os.environ["CPCSV_NUM_PROCESSES"]) * per_host
    print(f"rank {rank} of {world} on card {os.environ['LOCAL_RANK']}", flush=True)
    staged = Path(argv[0], f"pid{rank}.staged")
    staged.write_text(str(os.getpid()))
    os.replace(staged, Path(argv[0], f"pid{rank}"))  # whole when seen
    if rank == int(argv[1] if len(argv) > 1 else 1):
        deadline = time.monotonic() + 60
        while not Path(argv[0], "pid0").exists() and time.monotonic() < deadline:
            time.sleep(0.01)
        sys.exit(3)
    time.sleep(60)
