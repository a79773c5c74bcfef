#!/usr/bin/env python3
"""Run one benchmark cell once, on the card of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON line last on standard output
(correct, attempted, failed, metrics, device, with --trace 1 a breakdown,
and last the numbers compared, each with its limit), and those numbers as
the last lines of standard error. Exits nonzero and prints no result
without a CUDA card (or with fewer cards than the cell asks for), without
the program beside the benchmark, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the program builds its kernels into raytracinggrff_tpu_torch/_build/ of
# this checkout, at a fixed path, the first run of a cell and loads them
# from there after
sys.path[0] = str(ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
