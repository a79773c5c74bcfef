"""Benchmark harness of the port: the twin of the root bench.py, which
measures the JAX package.

    python bench_torch.py                 # ray-steps/sec/chip, on a card
    python bench_torch.py --pipeline      # pipeline-s-per-frequency
    python bench_torch.py --device cpu --n-pix 4 --n-steps 40 --grid-n 16

Prints ONE JSON line on stdout with bench.py's keys: metric, value, unit,
times_s, warmup_s and workload. The headline is the median of --repeat runs
after one warm-up. The warm-up includes the first-use nvcc build of the
trace kernel; the build's own seconds and the per-repeat notes go to
stderr. `workload` adds the steps that run, the device and, on a card,
the GPU's name and power limit as nvidia-smi gives them.

Workload (bench.py:32-48): a Newkirk-like density on UniformGrid.cube(3.0,
grid_n), overdense below r = 1, te 1.4e6 K and |B| 1 G; the n_pix^2
image-plane rays of pipeline.image_ray_starts(n_pix, 1.44, 3.0). The cubes
go to the device once, before the clock.

Trace mode (the default): tracer_segments.iter_trace_segments on --device
(dt 6e-3, perturb ratio 2.0, stride --record-stride, cross-sections on
unless --no-crosssections), with one on-device reduction chained per
segment, as bench.py chains `accum`, and read once per repeat after a
synchronize; the records stay on the device. The rate divides
n_pix^2 x steps_run by the median, where steps_run = 1 + (n_records - 1)
x stride are the steps the trace runs (4,991 at 5000 steps; PERF.md
section 2). bench.py:247 divides n_pix^2 x n_steps instead.

--pipeline: run_ray_tracing_emission on the four cubes as tensors on the
device, with the config of bench.py:127-133 (pipeline_config): extent and
observer 3.0, dt 6e-3, nfreq --nfreq, freq0 = --freq, log step 0.05, S
input on, --seg-records records a segment. The clock stops at the host
copy of the map, as at bench.py:139; the value is the median over nfreq.

Left out of bench.py, each for a reason:
  * --tracer: the port has one tracer on the card (pipeline.config_from_jax);
  * --rpt, --brick, --tile-factor, --ns-per-lane-step: knobs of the TPU
    kernel's tiling and of its cost model;
  * the v5e device model (bench.py:259-299);
  * vs_baseline: BASELINE_RATE (bench.py:29) is a TPU rate, and no TPU
    number is a baseline for the port.

--device cuda (the default) raises on a machine without a card; the CPU
runs only when asked for (--device cpu), and there the trace takes the
kernel's plain version, as everywhere in the port.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .grids import UniformGrid
from .ops import trace_segment as ts
from .pipeline import (RayEmissionConfig, image_ray_starts,
                       run_ray_tracing_emission)
from .tracer_segments import iter_trace_segments

EXTENT = 3.0
X_FOV = 1.44
Z_OBSERVER = 3.0
DT = 6e-3
PERTURB_RATIO = 2.0


def make_cube(grid_n, freq_hz):
    """bench.py's cube: (grid, omega_pe, ne), float32 numpy on
    UniformGrid.cube(3.0, grid_n)."""
    grid = UniformGrid.cube(EXTENT, grid_n)
    xs, ys, zs = grid.axes()
    x, y, z = np.meshgrid(xs, ys, zs, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    # Newkirk-like density -> omega_pe; overdense below r=1 so low-frequency
    # rays refract/reflect like the production scene.
    ne = 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.5))
    omega_pe = 8.93e3 * np.sqrt(ne) * 2 * np.pi
    return grid, omega_pe.astype(np.float32), ne.astype(np.float32)


def make_rays(n_pix, x_fov=X_FOV, z_obs=Z_OBSERVER):
    _, _, start, kdir = image_ray_starts(n_pix, x_fov, z_obs)
    return start, kdir


def steps_run(n_steps, record_stride):
    """RK4 steps a trace of n_steps runs: the first record after step 1,
    then one every record_stride steps, none after the last record."""
    n_records = -(-n_steps // record_stride)
    return 1 + (n_records - 1) * record_stride


def build_parser():
    p = argparse.ArgumentParser(
        description="Benchmark the port on bench.py's canonical workload")
    p.add_argument("--n-pix", type=int, default=256)
    p.add_argument("--n-steps", type=int, default=5000)
    p.add_argument("--grid-n", type=int, default=128)
    p.add_argument("--record-stride", type=int, default=10)
    p.add_argument("--freq", type=float, default=75e6)
    p.add_argument("--repeat", type=int, default=3)
    p.add_argument("--no-crosssections", action="store_true")
    p.add_argument("--seg-records", type=int, default=64)
    p.add_argument("--pipeline", action="store_true",
                   help="bench the full emission pipeline (trace + "
                        "streamed GRFF transfer) and report s/frequency")
    p.add_argument("--nfreq", type=int, default=3,
                   help="--pipeline: transfer frequencies per trace")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda)")
    return p


def pipeline_config(args):
    """The RayEmissionConfig of bench.py:127-133 for parsed `args`."""
    return RayEmissionConfig(
        n_pix=args.n_pix, freq_hz=args.freq, grid_n=args.grid_n,
        grid_extent=EXTENT, z_observer=Z_OBSERVER, dt=DT,
        n_steps=args.n_steps, record_stride=args.record_stride,
        nfreq=args.nfreq, freq0=args.freq, freq_log_step=0.05,
        s_input_on=True, seg_records=args.seg_records)


def smi_line(index=0):
    """nvidia-smi's `name, power limit` line for card `index`."""
    return subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def card_fields(device):
    """The GPU's name and power limit from nvidia-smi for a CUDA device,
    else {}."""
    if device.type != "cuda":
        return {}
    line = smi_line(device.index if device.index is not None else 0)
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"gpu": name, "power_limit": limit}


def main(argv=None):
    """Run the benchmark; prints the JSON line and returns its dict."""
    p = build_parser()
    args = p.parse_args(argv)
    if args.pipeline and args.no_crosssections:
        p.error("--pipeline does not honor --no-crosssections (the "
                "production pipeline traces cross-sections)")
    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device (pass "
                           f"--device cpu to run on the CPU)")

    def note(msg):
        print(msg, file=sys.stderr, flush=True)

    workload = {"n_pix": args.n_pix, "n_steps": args.n_steps,
                "grid_n": args.grid_n, "record_stride": args.record_stride,
                "freq_hz": args.freq,
                "crosssections": not args.no_crosssections,
                "seg_records": args.seg_records,
                "steps_run": steps_run(args.n_steps, args.record_stride),
                "device": str(device), **card_fields(device)}

    grid, omega_pe, ne = make_cube(args.grid_n, args.freq)
    cubes = {k: torch.as_tensor(v, device=device) for k, v in (
        ("omega_pe", omega_pe), ("ne", ne), ("te", np.full_like(ne, 1.4e6)),
        ("b", np.ones_like(ne)))}
    start, kdir = make_rays(args.n_pix)

    if args.pipeline:
        cfg = pipeline_config(args)
        workload["nfreq"] = args.nfreq

        def run():
            timings = {}
            res = run_ray_tracing_emission(config=cfg, cubes=cubes,
                                           verbose=False, device=device,
                                           timings=timings)
            # forcing the host cube is the honest completion point
            assert np.isfinite(res["emission_cube"]).any()
            return timings
    else:
        def run():
            # one chained device reduction per segment, forced once
            acc = torch.zeros((), device=device)
            for recs in iter_trace_segments(
                    cubes["omega_pe"], cubes["ne"], cubes["te"], cubes["b"],
                    grid, args.freq, start, kdir, DT, args.n_steps,
                    args.record_stride,
                    trace_crosssections=not args.no_crosssections,
                    perturb_ratio=PERTURB_RATIO,
                    seg_records=args.seg_records):
                acc += recs[-1, 0, 0]
            if cuda:
                torch.cuda.synchronize(device)
            float(acc)
            return None

    def stages(timings):
        if not timings:
            return ""
        return "  " + " ".join(f"{k} {timings[k]:.4f}s" for k in (
            "resample", "trace", "transfer", "finish"))

    with torch.inference_mode():
        t0 = time.perf_counter()
        if cuda:
            ts._library()
            note(f"trace kernel build and load: "
                 f"{time.perf_counter() - t0:.3f}s")
        stage_s = run()
        warmup_s = time.perf_counter() - t0
        note(f"warmup (incl. build): {warmup_s:.3f}s{stages(stage_s)}")
        times = []
        for i in range(args.repeat):
            t0 = time.perf_counter()
            stage_s = run()
            dt = time.perf_counter() - t0
            times.append(dt)
            per_freq = (f" ({dt / args.nfreq:.4f} s/freq)" if args.pipeline
                        else "")
            note(f"repeat {i}: {dt:.4f}s{per_freq}{stages(stage_s)}")
    median = float(np.median(times))

    if args.pipeline:
        out = {"metric": "pipeline-s-per-frequency",
               "value": median / args.nfreq, "unit": "s/freq/chip"}
    else:
        out = {"metric": "ray-steps/sec/chip",
               "value": args.n_pix ** 2 * workload["steps_run"] / median,
               "unit": "ray-steps/s"}
    out.update(times_s=times, warmup_s=warmup_s, workload=workload)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
