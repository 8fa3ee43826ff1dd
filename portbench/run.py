"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared with the reference, each beside its
limit, are the last lines of standard error. Without a CUDA card the run
exits with code 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, is where imports start
sys.path[0] = str(ROOT)
# every cache the program or its libraries keep sits in the checkout, at
# a fixed path, so that only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
os.environ["USE_FLAX"] = "0"
# one process with one compute thread on the host: the trials' host work
# (eager epoch, capture) shares the machine's cores with nothing of ours
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"

if __name__ == "__main__":
    from portbench.harness.cell import main

    sys.exit(main(sys.argv[1:], T_START))
