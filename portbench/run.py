"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the cell's checks beside their limits as the last lines of standard
error, and one JSON object as the last line of standard output. Exits
non-zero, with no result, without a CUDA card or the program in this
checkout (README.md).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench.lib import harness

    sys.exit(harness.main(sys.argv[1:], T0))
