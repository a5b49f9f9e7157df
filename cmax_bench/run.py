"""Run one cell of the benchmark of the PyTorch and CUDA port:

    python3 cmax_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port under `src/`. Prints the
result as one JSON object on the last line of standard output, and each
number the correctness check compared, beside its limit, as the last
lines of standard error. Exits with another code than 0, printing no
result, where the card the cell needs is missing.
"""
import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cmax_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_PROCESS))
