"""The benchmark of ``repro_torch`` on NVIDIA H100s: one run of one cell.

    python3 bench_h100/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout that holds ``BENCHMARK.json`` and
``src/repro_torch``.  The last line of standard output is the result
(JSON); the last lines of standard error are the compared numbers, each
beside its limit.  See ``benchlib/cli.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

if __name__ == "__main__":
    from benchlib import cli

    sys.exit(cli.main(sys.argv[1:], T_START, HERE.parent))
