#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, `bench/` and the
port under `src/`. Prints the card and its power limit, then, as the last
line of standard output, one JSON object: `correct`, `attempted`, `failed`,
the cell's end-to-end metrics (`--trace 0`) or per-layer metrics
(`--trace 1`), `device`, and `checks`, each compared number beside its
limit. Exits non-zero, with no result, where no CUDA card is found.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one process with one host thread for the math libraries: the program's
# host work is a single Python thread, and idle pools only add jitter
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
