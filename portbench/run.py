"""Run one cell of the benchmark once, on the card:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (one JSON object); the
numbers compared for `correct` are the last lines of standard error.
"""
import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root (for `portbench`) and `src` (the program); not this
# directory, whose module names would shadow others
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
