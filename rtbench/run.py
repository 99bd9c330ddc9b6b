"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m rtbench.run`` does the same). The
last line of standard output is the result; the numbers the check compared,
each beside its limit, are the last lines of standard error. Exits non-zero
with no result on a host without the card the cell asks for.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from rtbench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
