#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU, beyond the
pass/fail checks of chip_smoke.py.

    python3 profile_slice.py          # from the repository root, on a card

  1. fmad: the canonical first segment (65,536 rays x 631 steps) through
     the kernel built with -fmad=false (the default build) and with nvcc's
     FMA contraction: ptxas registers and spills of each build, the median of
     6 alternated timings of 10 launches each, and the agreement of each
     build with the plain version.
  2. spread: the production slice of chip_smoke.py (256^2 rays x 5000
     steps x 128^3 cube, nfreq 3) from a synthetic MAS model; one warm-up
     run, then 5 timed runs, with the median and quartiles of each stage.
  3. profile: one more run of the slice under torch.profiler; the time the
     device was busy (the union of its kernel and copy intervals) over the
     run's wall time, the number of device kernels and the kernels with
     the most device time.
  4. floor: the noise floor of the theta_mode='los' map that chip_smoke.py
     phase 7 holds to |dV/I| <= 1e-4 (n_pix 32 x 600 steps on a b0_gauss =
     50 model's 128^3 cubes, nfreq 2), for mechanism 5 and for mechanism 7
     (gyroresonance). Against the plain map: the plain map on cubes
     multiplied by (1 + 1e-7 N(0,1)), and the map through each build of
     phase 1. For each: lit values, max rel T_b, max and 99th percentile
     of |dV/I| and the count above 1e-4.
The card's name and power limit are printed first and last. Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (SLICE, canonical_scene, compare_records, cuda_ms,
                        initial_state, plain_segments, say, smi_line)

STAGES = ("wall", "resample", "trace", "transfer", "finish")


@contextlib.contextmanager
def kernel_library(lib):
    """Make the trace_segment wrapper launch from `lib`."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    saved = ts._library
    ts._library = lambda: lib
    try:
        yield
    finally:
        ts._library = saved


def build_libraries():
    """The kernel library with nvcc's FMA contraction ("fma") and as
    NVCC_FLAGS build it ("nofma", -fmad=false)."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    libs = {}
    fma_flags = tuple(f for f in ts.NVCC_FLAGS if f != "-fmad=false")
    for name, flags in (("fma", fma_flags), ("nofma", ts.NVCC_FLAGS)):
        path, log = ts.build_library(flags)
        libs[name] = ts.load_library(path)
        for line in log.splitlines():
            if "Compiling" in line or "spill" in line or "registers" in line:
                say(f"[fmad] {name} ptxas: {line.strip()}")
    return libs


def phase_fmad(libs):
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    from raytracinggrff_tpu_torch.tracer_segments import prepare_trace_inputs
    grid, f, start, kdir = canonical_scene()
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    args = (tcube, scube, state, grid, 6e-3, 1, 10, 64)
    times = {name: [] for name in libs}
    for _ in range(6):
        for name, lib in libs.items():
            with kernel_library(lib):
                times[name].append(
                    cuda_ms(lambda: ts.trace_segment(*args), reps=10))
    _, rec_p = ts.trace_segment_plain(*args)
    for name, lib in libs.items():
        with kernel_library(lib):
            _, rec_k = ts.trace_segment(*args)
        ok, worst = compare_records(rec_k, rec_p)
        say(f"[fmad] {name}: segment ms {['%.4f' % t for t in times[name]]}"
            f" median {np.median(times[name]):.4f}; {ok.mean():.6f} of rays"
            f" agree with plain; max |diff| per row "
            f"{['%.3g' % w for w in worst]}")


def run_slice(model, cfg):
    from raytracinggrff_tpu_torch.pipeline import run_ray_tracing_emission
    timings = {}
    t0 = time.perf_counter()
    run_ray_tracing_emission(model_path=model, config=cfg, verbose=False,
                             device="cuda", timings=timings)
    torch.cuda.synchronize()
    timings["wall"] = time.perf_counter() - t0
    return timings


def phase_spread(model, cfg):
    runs = []
    for i in range(6):
        timings = run_slice(model, cfg)
        say(f"[spread] run {i}{' (warm-up)' if i == 0 else ''}: "
            f"{json.dumps({k: round(v, 5) for k, v in timings.items()})}")
        if i:
            runs.append(timings)
    for key in STAGES:
        q1, med, q3 = np.percentile([r[key] for r in runs], [25, 50, 75])
        say(f"[spread] {key}: median {med:.5f} s, quartiles {q1:.5f} / "
            f"{q3:.5f} s, (q3 - q1) / median {(q3 - q1) / med:.4f}, "
            f"n={len(runs)}")


def busy_seconds(events):
    """Length of the union of the events' [start, end] intervals, in s."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6


def phase_profile(model, cfg):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timings = run_slice(model, cfg)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_seconds(dev)
    rounded = {k: round(v, 5) for k, v in timings.items()}
    say(f"[profile] stages {json.dumps(rounded)}")
    say(f"[profile] wall {timings['wall']:.4f} s, device busy {busy:.4f} s,"
        f" busy share {busy / timings['wall']:.4f}; {len(dev)} device "
        f"events")
    per_name = {}
    for e in dev:
        total, count = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (total, count) in top:
        say(f"[profile] {total / 1e3:10.3f} ms x {count:6d}  {name[:90]}")


def map_stats(tag, res, ref):
    """How far the map `res` is from `ref`, over the values lit in both."""
    a, b = ref["emission_cube"], res["emission_cube"]
    lit = (a > 1e4) & (b > 1e4)
    rel = np.abs(b[lit] - a[lit]) / a[lit]
    dv = np.abs(res["emission_polVI_cube"][lit]
                - ref["emission_polVI_cube"][lit])
    say(f"[floor] {tag}: {lit.sum()} lit values; max rel T_b "
        f"{rel.max():.3g}; |dV/I| max {dv.max():.3g}, p99 "
        f"{np.percentile(dv, 99):.3g}, {(dv > 1e-4).sum()} above 1e-4")


def jittered(cubes, seed=0):
    """Each cube multiplied by (1 + 1e-7 N(0,1)), drawn in float64."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jitter(v):
        n = torch.randn(v.shape, generator=gen, device=v.device,
                        dtype=torch.float64)
        return (v.double() * (1.0 + 1e-7 * n)).float()
    return {k: tuple(jitter(c) for c in v) if k == "bvec" else jitter(v)
            for k, v in cubes.items()}


def phase_floor(libs):
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    with tempfile.TemporaryDirectory() as tmp:
        model = MASModel(synthetic_mas_model(Path(tmp) / "corona_gr",
                                             b0_gauss=50.0))
        cubes = prepare_cubes(model, UniformGrid.cube(3.0, 128), 0.0,
                              verbose=False, keep_bvec=True, device="cuda")
    noisy = jittered(cubes)
    for mech in (5, 7):
        cfg = RayEmissionConfig(**dict(SLICE, n_pix=32, n_steps=600, nfreq=2,
                                       mechanism=mech, theta_mode="los"))

        def run(c):
            return run_ray_tracing_emission(cubes=c, config=cfg,
                                            verbose=False, device="cuda")
        with plain_segments():
            ref = run(cubes)
            map_stats(f"mechanism {mech}, plain on jittered cubes vs plain",
                      run(noisy), ref)
        for name, lib in libs.items():
            with kernel_library(lib):
                map_stats(f"mechanism {mech}, kernel {name} vs plain",
                          run(cubes), ref)


def main():
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig
    say(f"nvidia-smi: {smi_line()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    with torch.inference_mode():
        libs = build_libraries()
        phase_fmad(libs)
        with tempfile.TemporaryDirectory() as tmp:
            model = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
            cfg = RayEmissionConfig(**SLICE)
            phase_spread(model, cfg)
            phase_profile(model, cfg)
        phase_floor(libs)
    say(f"nvidia-smi: {smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
