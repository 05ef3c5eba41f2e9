"""Run one benchmark cell once and print its result as the last line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs the CUDA devices the cell asks for; exits non-zero with no result
without them.  See PERF.md for the cells and their metrics.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from portbench import harness
    sys.exit(harness.main(started=STARTED))
