"""The benchmark's command: one run of one cell.

    python3 -m flowbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json.  Prints the result
as one JSON line, last on standard output; the numbers the check compared
go last on standard error.  Exits 2, printing no result, without the CUDA
cards the cell asks for."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    from flowbench.harness import main

    sys.exit(main(sys.argv[1:], T_START, Path.cwd()))
