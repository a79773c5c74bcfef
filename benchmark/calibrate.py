#!/usr/bin/env python3
"""The readings from which a cell's limits are set, on the card:

    python3 benchmark/calibrate.py --workload <cell> --first-seed <n> \
        --seeds 12 --controls 3 --seconds 3

For each of --seeds seeds (first-seed, first-seed + 1, ...) it runs the
cell as a run does, with a short window at the cell's own load, and
prints the numbers the check compares ("program"). For the first
--controls of them it also computes the control: the plain reference in
bfloat16, the precision below the float32 the configurations state, put
in the program's place and compared with the float32 reference by the
same comparison ("control"). One JSON line per reading, all in one
process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402

from benchmark.harness import Cell, Run, run_window  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def readings(cell, seed, seconds, control, device, workdir):
    run = Run(cell, seconds, 0, device)
    ctx = cell.driver.setup(cell, seed, run.device, Path(workdir))
    run_window(run, ctx)
    cell.driver.collect(ctx, run)
    numbers = cell.driver.check(ctx, run)
    out = {"seed": seed, "units": len(run.units), "failed": run.failed,
           "program": {k: v for k, (v, _) in numbers.items()}}
    if control:
        t0 = time.perf_counter()
        low = cell.driver.reference(ctx, CONTROL_DTYPE)
        out["control"] = cell.driver.gaps(low, ctx.want)
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        torch.cuda.init()
    cell = Cell(args.workload)
    for i in range(args.seeds):
        seed = args.first_seed + i
        workdir = tempfile.mkdtemp(prefix="rgrff-calibrate-")
        try:
            with torch.inference_mode():
                out = readings(cell, seed, args.seconds, i < args.controls,
                               device, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
