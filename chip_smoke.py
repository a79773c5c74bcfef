#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the trace-segment kernel from raytracinggrff_tpu_torch/csrc, holds
it against its plain PyTorch version on the card, drives the production
emission map (256^2 rays x 5000 steps x 128^3 cube at 75 MHz, nfreq 3,
cross-sections and S input on) through run_ray_tracing_emission, and checks
the map; then drives the straight-LOS chain, the gyroresonance map, the
low-band LOS vs ray-tracing comparison, per-step cross-sections, three
maps of the TbSpectra sweep, the other device CLIs at the defaults of
their CLIs, the production map over multi-device meshes (spawned and from torchrun), a
map against the float64 transfer reference, the FMA build against the
shipped exact build over whole traces and maps, and the benchmark harness.
Phases:
  1. versions, card, kernel build: the shipped library (-fmad=false) and
     the FMA build (FMA_NVCC_FLAGS, for phase 14), one nvcc each, started
     together
  2. kernel vs plain on a non-reflecting scene, every ray within tolerance
  3. kernel vs plain on the canonical scene's first segment (>= 99% of
     rays within tolerance), with both times and the kernel's bound
  4. the main path at full size from a synthetic MAS model, run twice
  5. the map through the kernel vs through the plain version (n_pix 32),
     max |dV/I| <= 1e-4
  6. resample_mas_los + synthetic_ff at the CLI defaults (128^2 x 400
     samples; 450 MHz, 4 frequencies)
  7. the gyroresonance map (mechanism 7, theta_mode 'los', 8-channel
     records) at the size of phase 4 on a b0_gauss = 50 model, its change
     from mechanism 5, and kernel vs plain at n_pix 32 under the GR bar
     (DV_BAR_GR)
  8. compare_los_raytracing's low band: 30, 60 and 120 MHz, 128^2 pixels,
     a 256^3 cube at extent 4
  9. s_mode='per_step': kernel vs plain on phase 2's scene (every ray
     within tolerance, row 3 unlike the cumulative records), and the
     n_pix 32 map with S input, kernel vs plain under DV_BAR_FIXED
 10. the TbSpectra sweep (cli/tb_spectra.run_sweep at its CLI defaults:
     128^2 pixels, phi0 -140, lattice presets) at indices 0, 16 and 29 of
     its 30 frequencies (30, 183.6 and 800 MHz; the last on a 576^3 cube),
     with stage times and peak device memory, and each map's first
     segment kernel vs plain (>= 99% of rays within tolerance)
 11. the other device CLIs at their defaults: bench, demo_rays (cross-
     sections off), compare_s_input and plot_model_slices.sample_plane;
     the first segment of bench (>= 99% of rays) and of demo_rays (every
     ray) kernel vs plain
 12. the production map over meshes (parallel/): (1, 1) in this process on
     nccl, (2, 1) and (2, 2) (nfreq 4) as spawned ranks on the one card
     with gloo, against the one-process map (T_b rtol 1e-6, V/I atol
     1e-6), each rank's launches = segments; (2, 1) from `python -m
     torch.distributed.run --standalone --nproc-per-node 2` (make_mesh's
     env:// rendezvous, both ranks on cuda:0 over gloo) under the same
     bar, its exit code checked; then parallel.dryrun.dryrun_multichip(4)
     with gloo on the card
 13. phase 5's map through the kernel against the float64 reference
     (grff/reference.py) on the same records: lit on-disk T_b within 1%
 14. the FMA build (FMA_NVCC_FLAGS) vs the shipped, exact build: (a) the
     canonical trace (256^2 x 5000 steps x 128^3, 8 segments) in
     lockstep, every record under ROW_TOL (printed per segment, with the
     rays that part; asserted: no value NaN in one build only), and the
     first segment's time through each; (b) the shipped build's last
     segment against the plain version from the same state, rows 0-6 bit
     for bit; (c) the production map and sweep index 29 (800 MHz, 576^3)
     through both, against DV_BAR_FIXED and rel T_b 5e-3 over lit on-disk
     values, with the worst pixels; where the FMA build misses a bar, the
     shipped flags must hold -fmad=false
 15. the benchmark harness (bench_torch.py) at the canonical size, trace
     and pipeline mode, --repeat 3: its two JSON lines, 32 launches each
Each path that traces rays runs with the launch count set to 0 just
before it and checks it against its segment count just after.
The last lines are one JSON object per kernel, the card's name and power
limit, and {"ok": true, "device": {...}}. Any failure is a traceback and a
nonzero exit; without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from raytracinggrff_tpu_torch.harness import (make_cube, make_rays, smi_line,
                                              steps_run)

KERNEL_SOURCE = "raytracinggrff_tpu_torch/csrc/trace_segment.cu"
KERNEL_REPLACES = "raytracinggrff_tpu/ops/pallas_trace.py:654"
# record-row tolerances (atol, rtol) of tests/test_pallas_trace.py:52-65
ROW_TOL = [(2e-4, 2e-4)] * 3 + [(5e-4, 5e-3), (1e-2, 1e-3), (1.0, 1e-3),
                                (1e-3, 1e-3), (1e-4, 0.0)]
# kernel-vs-plain bars on |dV/I| over lit map values: (max, 99th
# percentile, share of values above 1e-4). The gyroresonance map moves V/I
# by up to 2.7e-4 (p99 2.2e-5) when its cubes change by 1e-7 relative
# (profile_slice.py phase floor), so its bar sits above that floor; the
# fixed-theta map's floor is about 100x lower and keeps a max of 1e-4.
DV_BAR_FIXED = (1e-4, 1e-4, 0.0)
DV_BAR_GR = (1e-3, 1e-4, 0.01)
# The H100 SXM's peak float32 rate outside the tensor cores and its memory
# rate (NVIDIA's data sheet, at 700 W), for the kernel's bound.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float32 operations of csrc/trace_segment.cu, counting each add, multiply,
# divide and square root as one (compares, clamps and floors not counted).
# One trace-cube evaluation is locate 9 + seven lerp4 91 + rhs 18 = 118.
# A cross-section step is the central RK4 (4 evaluations + 80) 552, the
# transverse basis 52, two perturbed RK4s (4 evaluations + 65 each) 1074
# and the area ratio 24. A record is locate 9 + 91 per float4 group + 1,
# + 19 for cos theta with 8 channels.
FLOPS_PER_STEP = 1702
FLOPS_PER_RECORD = {4: 101, 8: 211}
SLICE = dict(n_pix=256, x_fov=1.44, freq_hz=75e6, grid_n=128,
             grid_extent=3.0, z_observer=3.0, dt=6e-3, n_steps=5000,
             record_stride=10, nfreq=3, freq0=75e6, freq_log_step=0.05,
             s_input_on=True, mechanism=5, theta_deg=90.0)


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def record_agreement(rec_a, rec_b):
    """Agreement of (rps, 8, n_rays) record blocks under ROW_TOL on their
    device (NaN matches NaN): the (rps, n_rays) mask of records within
    tolerance in every row, and the max |diff| per row."""
    a, b = rec_a.double(), rec_b.double()
    ok = torch.ones((a.shape[0], a.shape[2]), dtype=torch.bool,
                    device=a.device)
    worst = []
    for row, (atol, rtol) in enumerate(ROW_TOL):
        x, y = a[:, row], b[:, row]
        same_nan = torch.isnan(x) & torch.isnan(y)
        diff = torch.where(same_nan, 0.0, (x - y).abs())
        ok &= (diff <= atol + rtol * y.abs()) | same_nan
        worst.append(float(diff[~torch.isnan(diff)].max())
                     if torch.isfinite(diff).any() else float("nan"))
    return ok, worst


def compare_records(rec_k, rec_p):
    """Per-ray agreement of (rps, 8, n_rays) record blocks under ROW_TOL
    (NaN matches NaN); returns (ok mask over rays, max |diff| per row)."""
    ok, worst = record_agreement(rec_k, rec_p)
    return ok.all(dim=0).cpu().numpy(), worst


def bundle_scene(n=41, extent=2.0, freq=80e6):
    """The refracting bundle scene of tests/test_pallas_trace.py, with a
    B vector for the 8-channel sample cube."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    grid = UniformGrid.cube(extent, n)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    omega0 = 2 * np.pi * freq
    wpe = 0.9 * omega0 * np.exp(-(r - 1.0) / 0.6)
    wpe[r < 1.0] = 0.9 * omega0
    fields = dict(wpe=wpe, ne=1e8 * np.exp(-(r - 1.0) / 0.5),
                  te=1e6 + 1e5 * z, b=1.0 + 0.2 * x, bx=1.0 + 0.2 * x,
                  by=0.5 * y - 0.3, bz=0.2 - 0.4 * z)
    return grid, {k: torch.as_tensor(v.astype(np.float32), device="cuda")
                  for k, v in fields.items()}


def canonical_scene(n_pix=256):
    """The canonical trace workload of bench.py and of the port's harness
    (harness.make_cube, make_rays): a Newkirk-like density cube, 128^3,
    overdense below r = 1, and the n_pix^2 image-plane rays."""
    grid, wpe, ne = make_cube(128, 75e6)
    t = {k: torch.as_tensor(v, device="cuda")
         for k, v in dict(wpe=wpe, ne=ne, te=np.full_like(ne, 1.4e6),
                          b=np.ones_like(ne)).items()}
    start, kdir = make_rays(n_pix)
    return grid, t, start, kdir


@contextlib.contextmanager
def kernel_library(lib):
    """Make the trace_segment wrapper launch from `lib` (a library of
    ops/trace_segment.load_library) while the block runs."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    saved = ts._library
    ts._library = lambda: lib
    try:
        yield
    finally:
        ts._library = saved


@contextlib.contextmanager
def plain_segments():
    """Route the segment driver through the plain version on CUDA tensors
    for a comparison run; the wrapper itself never does."""
    from raytracinggrff_tpu_torch import tracer_segments
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment_plain
    saved = tracer_segments.trace_segment
    tracer_segments.trace_segment = trace_segment_plain
    try:
        yield
    finally:
        tracer_segments.trace_segment = saved


@contextlib.contextmanager
def first_segments(keep_cubes=False):
    """Record, in order, the arguments of each trace_segment launch of
    tracer_segments that starts a trace (n_first == 1) while the block
    runs; the cubes only with keep_cubes (else None), so that a sweep need
    not keep every map's cube set alive. The launches run and count as
    usual."""
    from raytracinggrff_tpu_torch import tracer_segments
    launch = tracer_segments.trace_segment
    seen = []

    def spy(tcube, scube, *rest):
        if rest[3] == 1:
            seen.append((tcube, scube, *rest) if keep_cubes
                        else (None, None, *rest))
        return launch(tcube, scube, *rest)

    tracer_segments.trace_segment = spy
    try:
        yield seen
    finally:
        tracer_segments.trace_segment = launch


def hold_segment(tag, what, args, min_share):
    """One segment's arguments through the kernel and through the plain
    version: at least min_share of the rays within ROW_TOL (1.0, or 0.99
    where rays reflect and may part after many steps). Returns the
    kernel's records and the max |diff| per row."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    _, rec_k = trace_segment(*args)
    _, rec_p = trace_segment_plain(*args)
    ok, worst = compare_records(rec_k, rec_p)
    n_first, stride = args[5], args[6]
    steps = n_first + (rec_k.shape[0] - 1) * stride
    say(f"[{tag}] {what} ({ok.size} rays, {steps} steps, "
        f"{'x'.join(map(str, args[0].shape[:3]))} cube): kernel vs plain, "
        f"{ok.mean():.5f} of rays within tolerance; max |diff| per row "
        f"{['%.3g' % w for w in worst]}")
    assert ok.mean() >= min_share, f"only {ok.mean():.4f} of rays agree"
    return rec_k, worst


def build_all(flag_sets):
    """Build every {name: nvcc flags} library at once (one nvcc each) and
    load them; prints each build's ptxas registers and spills."""
    from concurrent.futures import ThreadPoolExecutor

    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    with ThreadPoolExecutor(len(flag_sets)) as pool:
        built = dict(zip(flag_sets, pool.map(ts.build_library,
                                             flag_sets.values())))
    libs = {}
    for name, (path, log) in built.items():
        libs[name] = ts.load_library(path)
        for line in log.splitlines():
            if "Compiling" in line or "spill" in line or "registers" in line:
                say(f"[build] {name} ptxas: {line.strip()}")
    return libs


def phase_build():
    """Build the shipped library (NVCC_FLAGS) and the FMA build
    (FMA_NVCC_FLAGS, measured in phase 14) at once; returns the FMA
    library."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    say(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    libs = build_all({"shipped": ts.NVCC_FLAGS, "fma": ts.FMA_NVCC_FLAGS})
    ts._library()
    say(f"[1] built the shipped and the FMA library in "
        f"{time.perf_counter() - t0:.1f} s, one nvcc each at once (nvcc "
        f"{' '.join(ts.NVCC_FLAGS)}; the FMA build drops -fmad=false)")
    return libs["fma"]


def small_segment_args():
    """Phase 2's segment on the bundle scene, 4096 rays with 8 frozen
    out-of-cube ones, 31 records: the kernel arguments for the 4- and the
    8-channel sample cube."""
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid, f = bundle_scene()
    rng = np.random.default_rng(0)
    n = 4096
    start = np.column_stack([0.6 + rng.uniform(-0.1, 0.1, n),
                             rng.uniform(-0.1, 0.1, n),
                             np.full(n, 1.9)]).astype(np.float32)
    start[:8, 0] = 50.0                     # frozen out-of-cube rays
    kdir = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    for bvec in (None, (f["bx"], f["by"], f["bz"])):
        tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"],
                                            f["b"], grid, bvec)
        state = initial_state(tcube, grid, 80e6, start, kdir)
        yield tcube, scube, state, grid, 5e-3, 1, 10, 31


def phase_small(out, tag="2", s_mode="cumulative"):
    """Kernel vs plain on small_segment_args, every ray within ROW_TOL;
    with per-step S, row 3 also differs from the cumulative kernel's on
    most live records. Keeps the largest difference in positions and, with
    per-step S, in row 3 in out["max_abs_err"]."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    worst_r = out.get("max_abs_err", 0.0)
    for args in small_segment_args():
        n = args[2].shape[1]
        _, rec_k = trace_segment(*args, s_mode=s_mode)
        _, rec_p = trace_segment_plain(*args, s_mode=s_mode)
        torch.cuda.synchronize()
        ok, worst = compare_records(rec_k, rec_p)
        nch = args[1].shape[3]
        say(f"[{tag}] {nch}-channel, {s_mode} S: {ok.sum()}/{n} rays within "
            f"tolerance; max |diff| per row {['%.3g' % w for w in worst]}")
        assert ok.all(), f"{(~ok).sum()} rays outside tolerance ({nch} ch)"
        assert torch.all(rec_k[-1, 3, :8] < 1e-6), "frozen rays kept S"
        if s_mode == "per_step":
            _, rec_c = trace_segment(*args)
            live = rec_c[1:, 3] > 0
            differ = (rec_k[1:, 3] != rec_c[1:, 3])[live].double().mean()
            say(f"[{tag}] row 3 differs from the cumulative records on "
                f"{float(differ):.5f} of {int(live.sum())} live records")
            assert differ > 0.9, float(differ)
        worst_r = max(worst_r, *worst[:4 if s_mode == "per_step" else 3])
    out["max_abs_err"] = worst_r


def segment_bound_ms(tcube, scube, state, rec, n_first, stride):
    """Least time the card needs for one segment: the larger of its float32
    operations at PEAK_F32_FLOPS and its bytes (each cube, the state in
    and out and the records once) at PEAK_BYTES_S. Only steps of rays that
    are still in the cube count: those of each record block that ends with
    S > 0 (a frozen ray's S drops to 0). Returns (ms, "operations" or
    "bytes")."""
    rps = rec.shape[0]
    live = (rec[:, 3] > 0).sum(dim=1).double().cpu().numpy()
    steps = np.full(rps, float(stride))
    steps[0] = n_first
    ops = (FLOPS_PER_STEP * float((live * steps).sum())
           + FLOPS_PER_RECORD[scube.shape[3]] * float(live.sum()))
    nbytes = 4 * (tcube.numel() + scube.numel() + 2 * state.numel()
                  + rec.numel())
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_canonical(out):
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid, f, start, kdir = canonical_scene()
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    args = (tcube, scube, state, grid, 6e-3, 1, 10, 64)
    rec_k, _ = hold_segment("3", "canonical first segment", args, 0.99)
    ms = cuda_ms(lambda: trace_segment(*args), reps=5)
    plain_ms = cuda_ms(lambda: trace_segment_plain(*args), reps=1)
    bound_ms, bound_by = segment_bound_ms(tcube, scube, state, rec_k, 1, 10)
    steps = 65536 * 631
    say(f"[3] segment time: kernel {ms:.3f} ms "
        f"({steps / ms * 1e3:.4g} ray-steps/s), plain {plain_ms:.1f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.4f} of it")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by)


def phase_main(out, tmp):
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   run_ray_tracing_emission)
    model = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
    cfg = RayEmissionConfig(**SLICE)
    npz = Path(tmp) / "ray_tracing_emission.npz"
    n_seg = n_segments(cfg)
    steps = steps_run(cfg.n_steps, cfg.record_stride)
    for run in (1, 2):
        timings = {}
        trace_segment.launches = 0
        t0 = time.perf_counter()
        res = run_ray_tracing_emission(model_path=model, config=cfg,
                                       out_path=npz, verbose=False,
                                       device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
        assert launches == n_seg == timings["segments"], (launches, n_seg)
        rate = 256 * 256 * steps / timings["trace"]
        say(f"[4] run {run}: wall {wall:.3f} s; resample "
            f"{timings['resample']:.4f} s, trace {timings['trace']:.4f} s "
            f"({rate:.4g} ray-steps/s over {steps} steps), transfer "
            f"{timings['transfer']:.4f} s, finish {timings['finish']:.4f} s;"
            f" kernel launches {launches} = segments {n_seg}")
    tb = res["emission_cube"]
    assert tb.shape == (256, 256, 3) and np.all(np.isfinite(tb)), tb.shape
    disk = np.load(npz)["emission_cube"]
    xs = np.linspace(-1.44, 1.44, 256)
    on_disk = (xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0
    vals = disk[on_disk]
    inside = (vals > 1e4) & (vals < 3e6)
    pct = np.percentile(vals, [0, 1, 50, 99, 100])
    say(f"[4] on-disk T_b: {inside.mean():.5f} of {vals.size} values in "
        f"1e4..3e6 K; percentiles 0/1/50/99/100: "
        f"{', '.join('%.4g' % p for p in pct)}")
    assert inside.all(), "on-disk T_b outside 1e4..3e6 K"
    out.update(launches=launches, wall=wall, timings=timings)
    return res


def map_kernel_vs_plain(tag, cubes, bar, device="cuda", **overrides):
    """The n_pix 32 x 600-step map through the kernel and through the
    plain version on the same cubes: rel T_b <= 5e-3 (the bar of
    tests/test_streamed_pipeline.py) and |dV/I| within `bar`, one of
    DV_BAR_FIXED and DV_BAR_GR."""
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   run_ray_tracing_emission)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    cfg = RayEmissionConfig(**dict(SLICE, n_pix=32, n_steps=600, nfreq=2,
                                   **overrides))
    trace_segment.launches = 0
    r_k = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                   device=device)
    launches = trace_segment.launches
    assert launches == n_segments(cfg), (launches, n_segments(cfg))
    with plain_segments():
        r_p = run_ray_tracing_emission(cubes=cubes, config=cfg,
                                       verbose=False, device=device)
    hold_maps(tag, f"map kernel vs plain ({cfg.s_mode} S, {launches} "
              f"kernel launch(es))", r_p, r_k, bar)


def map_diff(tag, what, ref, test, bar, disk=None):
    """How far the map `test` lies from `ref` (result dicts) over lit
    values (> 1e4 K in both; on the disk too where `disk` is given),
    printed beside the map bars: rel T_b <= 5e-3 (the bar of
    tests/test_streamed_pipeline.py) and |dV/I| within `bar`, one of
    DV_BAR_FIXED and DV_BAR_GR. Returns the numbers and whether the bars
    hold."""
    a, b = ref["emission_cube"], test["emission_cube"]
    lit = (a > 1e4) & (b > 1e4)
    if disk is not None:
        lit &= disk[:, :, None]
    rel = np.abs(b[lit] - a[lit]) / a[lit]
    dv = np.abs(test["emission_polVI_cube"][lit]
                - ref["emission_polVI_cube"][lit])
    p99 = np.percentile(dv, 99)
    above = int((dv > 1e-4).sum())
    held = bool(lit.sum() > 20 and rel.max() <= 5e-3 and dv.max() <= bar[0]
                and p99 <= bar[1] and above <= bar[2] * dv.size)
    say(f"[{tag}] {what}: {lit.sum()} lit values, max rel T_b diff "
        f"{rel.max():.3g}, |V/I diff| max {dv.max():.3g}, p99 {p99:.3g}, "
        f"{above} above 1e-4 (bar: max {bar[0]:g}, p99 {bar[1]:g}, share "
        f"above 1e-4 {bar[2]:g}; {'held' if held else 'missed'})")
    return {"lit": int(lit.sum()), "max_rel_tb": float(rel.max()),
            "max_dv": float(dv.max()), "p99_dv": float(p99), "above": above,
            "held": held}


def hold_maps(tag, what, ref, test, bar, disk=None):
    """map_diff, asserting that the bars hold."""
    out = map_diff(tag, what, ref, test, bar, disk)
    assert out["held"], out
    return out


def worst_pixels(tag, ref, test, n=3):
    """Print the n pixels of largest rel T_b difference between two maps:
    (row, column, frequency), both T_b and V/I, and the mean T_b of each
    map's four neighbours of the pixel."""
    a, b = ref["emission_cube"], test["emission_cube"]
    rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-30)
    for flat in np.argsort(rel, axis=None)[::-1][:n]:
        i, j, f = np.unravel_index(flat, a.shape)
        near = [(i + di, j + dj) for di, dj in ((-1, 0), (1, 0), (0, -1),
                                                (0, 1))
                if 0 <= i + di < a.shape[0] and 0 <= j + dj < a.shape[1]]
        say(f"[{tag}] pixel ({i}, {j}, {f}): T_b {b[i, j, f]:.6g} vs "
            f"{a[i, j, f]:.6g} K (rel {rel[i, j, f]:.3g}), V/I "
            f"{test['emission_polVI_cube'][i, j, f]:.4g} vs "
            f"{ref['emission_polVI_cube'][i, j, f]:.4g}; neighbours' mean "
            f"T_b {np.mean([b[p][f] for p in near]):.6g} vs "
            f"{np.mean([a[p][f] for p in near]):.6g} K")


def phase_map():
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.pipeline import prepare_cubes
    with tempfile.TemporaryDirectory() as tmp:
        model = MASModel(synthetic_mas_model(Path(tmp) / "corona"))
        cubes = prepare_cubes(model, UniformGrid.cube(3.0, 128), 0.0,
                              verbose=False, device="cuda")
    map_kernel_vs_plain("5", cubes, DV_BAR_FIXED)
    return cubes


def phase_per_step(out, cubes):
    """s_mode='per_step' through the kernel: phase 2's segment, then phase
    5's map with S input (each record's area is its last step's S times
    the pixel area)."""
    phase_small(out, "9", "per_step")
    map_kernel_vs_plain("9", cubes, DV_BAR_FIXED, s_mode="per_step")


def n_segments(cfg):
    n_rec = -(-cfg.n_steps // cfg.record_stride)
    return -(-n_rec // cfg.seg_records)


def disk_mask(n_pix, x_fov):
    xs = np.linspace(-x_fov, x_fov, n_pix)
    return (xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0


def check_disk_tb(tag, tb, disk):
    """Every T_b finite and every on-disk value in 1e4..3e6 K."""
    assert np.all(np.isfinite(tb)), f"[{tag}] non-finite T_b"
    vals = tb[disk]
    pct = np.percentile(vals, [0, 50, 100])
    say(f"[{tag}] on-disk T_b: {vals.size} values, min/median/max "
        f"{', '.join('%.4g' % p for p in pct)} K")
    assert np.all((vals > 1e4) & (vals < 3e6)), f"[{tag}] T_b off range"


def phase_los(tmp, n_pix=128, device="cuda"):
    """The straight-LOS chain at the defaults of cli/resample_los.py and
    cli/synthetic_ff.py (no rays are traced, so no kernel launches)."""
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.pipeline import (resample_mas_los,
                                                   synthetic_ff)
    model = synthetic_mas_model(Path(tmp) / "corona_los")
    t0 = time.perf_counter()
    los = resample_mas_los(model, n_pix=n_pix, x_range=(-1.44, 1.44),
                           y_range=(-1.44, 1.44), n_z=400, dz0=3e-4,
                           phi0_offset=24.0, verbose=False, device=device)
    t1 = time.perf_counter()
    em = synthetic_ff(los, 450e6, 4, 0.1, verbose=False, device=device)
    t2 = time.perf_counter()
    say(f"[6] resample_mas_los {n_pix}^2 x 400 ({n_pix ** 2 * 400} samples "
        f"per variable): {t1 - t0:.3f} s; synthetic_ff 4 frequencies from "
        f"450 MHz: {t2 - t1:.3f} s")
    tb = em["emission_cube"]
    assert tb.shape == (n_pix, n_pix, 4), tb.shape
    check_disk_tb("6", tb, disk_mask(n_pix, 1.44)[:, :, None].repeat(4, 2))
    return {"resample_s": t1 - t0, "transfer_s": t2 - t1}


def phase_gyro(tmp, n_pix=256, n_steps=5000, grid_n=128, device="cuda"):
    """The gyroresonance map at full width on a b0_gauss = 50 model, its
    change from mechanism 5 on the same cubes, and the kernel vs the plain
    version at n_pix 32 and 600 steps."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    model = synthetic_mas_model(Path(tmp) / "corona_gr", b0_gauss=50.0)
    common = dict(SLICE, n_pix=n_pix, n_steps=n_steps, grid_n=grid_n,
                  theta_mode="los")
    cfg = RayEmissionConfig(**dict(common, mechanism=7))
    timings = {}
    trace_segment.launches = 0
    t0 = time.perf_counter()
    res = run_ray_tracing_emission(model_path=model, config=cfg,
                                   verbose=False, device=device,
                                   timings=timings)
    wall = time.perf_counter() - t0
    launches = trace_segment.launches
    say(f"[7] gyroresonance map {n_pix}^2 x {n_steps} steps x {grid_n}^3: "
        f"wall {wall:.3f} s; resample {timings['resample']:.4f} s, trace "
        f"{timings['trace']:.4f} s, transfer {timings['transfer']:.4f} s, "
        f"finish {timings['finish']:.4f} s; kernel launches {launches} = "
        f"segments {n_segments(cfg)}")
    assert launches == n_segments(cfg) == timings["segments"], launches
    tb7 = res["emission_cube"]
    disk = disk_mask(n_pix, cfg.x_fov)
    check_disk_tb("7", tb7, disk[:, :, None].repeat(cfg.nfreq, 2))
    cubes = prepare_cubes(MASModel(model), UniformGrid.cube(3.0, grid_n),
                          0.0, verbose=False, keep_bvec=True, device=device)
    tb5 = run_ray_tracing_emission(
        cubes=cubes, config=RayEmissionConfig(**dict(common, mechanism=5)),
        verbose=False, device=device)["emission_cube"]
    changed = np.abs(tb7[disk] / tb5[disk] - 1.0) > 0.01
    say(f"[7] {changed.mean():.5f} of {changed.size} on-disk values differ "
        f"by more than 1% from mechanism 5")
    assert changed.mean() > 0.5, changed.mean()
    map_kernel_vs_plain("7", cubes, DV_BAR_GR, device=device, grid_n=grid_n,
                        mechanism=7, theta_mode="los")
    return {"wall": wall, "timings": timings, "changed": changed.mean()}


def phase_compare(tmp, n_pix=128, grid_n=256, freqs=(30e6, 60e6, 120e6),
                  device="cuda"):
    """compare_los_raytracing's per-frequency body at its low-band
    defaults: x_fov 2.8, a grid_n^3 cube at extent 4, z_observer 4."""
    from raytracinggrff_tpu_torch.cli.compare_los_raytracing import (
        compare_frequency, frequency_scaled_params)
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig
    model = synthetic_mas_model(Path(tmp) / "corona_cmp")
    disk = disk_mask(n_pix, 2.8)
    out = {}
    for freq in freqs:
        p = frequency_scaled_params(freq)
        cfg = RayEmissionConfig(n_steps=p["n_steps"],
                                record_stride=p["record_stride"])
        timings = {}
        trace_segment.launches = 0
        t0 = time.perf_counter()
        ray, los = compare_frequency(model, freq, n_pix=n_pix, x_fov=2.8,
                                     grid_n=grid_n, grid_extent=4.0,
                                     z_observer=4.0, verbose=False,
                                     device=device, timings=timings)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
        a = ray["emission_cube"][:, :, 0]
        b = los["emission_cube"][:, :, 0]
        assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
        assert launches == n_segments(cfg), (launches, n_segments(cfg))
        ratio = np.median(a[disk]) / np.median(b[disk])
        say(f"[8] {freq / 1e6:.0f} MHz ({p['n_steps']} steps, stride "
            f"{p['record_stride']}, n_z {p['n_z']}): {wall:.3f} s for both "
            f"maps; ray stages resample {timings['resample']:.4f}, trace "
            f"{timings['trace']:.4f}, transfer {timings['transfer']:.4f} s; "
            f"kernel launches {launches} = segments {n_segments(cfg)}; "
            f"on-disk median T_b ray/LOS {ratio:.4f}")
        out[freq] = {"wall": wall, "ratio": ratio}
    return out


SWEEP_INDICES = (0, 16, 29)


def phase_sweep(tmp, indices=SWEEP_INDICES, compare=SWEEP_INDICES,
                n_pix=128, device="cuda"):
    """The TbSpectra sweep's maps at `indices` of its 30 default
    frequencies, through one run_sweep at the CLI defaults (phi0 -140,
    lattice presets), so that maps that share a cube set reuse it as the
    CLI does. Per map: its preset, stage times and peak device memory,
    every T_b finite, the on-disk median in 1e4..3e6 K and the share of
    on-disk values outside that range; over the run, kernel launches =
    segments. Then each map at `compare` has its first segment (the
    sweep's own rays, state, stride and records per segment, on its cube
    set made anew) held kernel vs plain as phase 3 holds the canonical
    one. Returns (the per-map timings dicts, the run's wall seconds)."""
    from raytracinggrff_tpu_torch.cli.tb_spectra import (run_sweep,
                                                         sweep_frequencies)
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.pipeline import prepare_cubes
    from raytracinggrff_tpu_torch.tracer_segments import prepare_trace_inputs
    model = synthetic_mas_model(Path(tmp) / "corona_sweep")
    freqs = sweep_frequencies()[list(indices)]
    timings = []
    with first_segments() as firsts:
        trace_segment.launches = 0
        t0 = time.perf_counter()
        rows = run_sweep(model, freqs, Path(tmp) / "mfs", n_pix=n_pix,
                         phi0_offset=-140.0, device=device, timings=timings,
                         verbose=False)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
    segments = sum(t["segments"] for t in timings)
    say(f"[10] {len(rows)} map(s): wall {wall:.3f} s; kernel launches "
        f"{launches} = segments {segments}")
    assert launches == segments, (launches, segments)
    assert len(firsts) == len(timings), (len(firsts), len(timings))
    for i, t, row in zip(indices, timings, rows):
        peak = ("not measured on the CPU" if t["peak_bytes"] is None
                else f"{t['peak_bytes'] / 2 ** 30:.3f} GiB")
        tb = np.load(row["npz"])["emission_cube"][:, :, 0]
        assert tb.shape == (n_pix, n_pix) and np.all(np.isfinite(tb))
        vals = tb[disk_mask(n_pix, t["x_fov"])]
        med = float(np.median(vals))
        off = float(np.mean((vals <= 1e4) | (vals >= 3e6)))
        say(f"[10] index {i}: {t['freq_hz'] / 1e6:.3f} MHz, {t['grid_n']}^3 "
            f"at extent {t['grid_extent']}, {t['n_steps']} steps, stride "
            f"{t['record_stride']}, {t['records']} records; resample "
            f"{t['resample']:.4f} s, trace {t['trace']:.4f} s, transfer "
            f"{t['transfer']:.4f} s, finish {t['finish']:.4f} s, segments "
            f"{t['segments']}; peak device memory {peak}; on-disk T_b median "
            f"{med:.4g} K, min {vals.min():.4g}, max {vals.max():.4g}, "
            f"{off:.5f} of {vals.size} values outside 1e4..3e6 K")
        if off:
            flat = np.flatnonzero((disk_mask(n_pix, t["x_fov"])
                                   & ((tb <= 1e4) | (tb >= 3e6))).ravel())
            say(f"[10] index {i}: flat pixel indices (i * {n_pix} + j) of "
                f"the on-disk values outside 1e4..3e6 K: {flat.tolist()}")
        assert 1e4 < med < 3e6, med
        t.update(index=i, median=med, off_range=off)
    for i, first in zip(indices, firsts):
        if i not in compare:
            continue
        grid = first[3]
        cubes = prepare_cubes(MASModel(model), grid, -140.0, verbose=False,
                              device=device)
        tcube, scube = prepare_trace_inputs(cubes["omega_pe"], cubes["ne"],
                                            cubes["te"], cubes["b"], grid)
        del cubes
        hold_segment("10", f"index {i}: first segment", (tcube, scube,
                                                         *first[2:]), 0.99)
        del tcube, scube
    return timings, wall


def phase_cli(tmp, device="cuda"):
    """bench, demo_rays, compare_s_input and sample_plane at their CLI
    defaults, with the kernel launches of each traced path; the first
    segment of bench's trace and of demo_rays' is held kernel vs plain."""
    from raytracinggrff_tpu_torch.cli import bench, compare_s_input
    from raytracinggrff_tpu_torch.cli.demo_rays import (build_parser,
                                                        trace_demo_rays)
    from raytracinggrff_tpu_torch.cli.plot_model_slices import sample_plane
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.tracer_segments import segment_plan
    model = synthetic_mas_model(Path(tmp) / "corona_cli")

    say("[11] bench (256^2 rays x 1000 trace steps on 128^3; 256^2 x 256 "
        "LOS samples), its two lines:")
    with first_segments(keep_cubes=True) as firsts:
        trace_segment.launches = 0
        t0 = time.perf_counter()
        bench.main(["--device", device])
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
    runs = 1 + bench.build_parser().get_default("repeat")
    expect = runs * len(segment_plan(1000, 10, 64)[0])
    say(f"[11] bench: {wall:.3f} s; kernel launches {launches} = {runs} "
        f"traces x segments")
    assert launches == expect, launches
    hold_segment("11", "bench's first segment", firsts[0], 0.99)
    del firsts

    args = build_parser().parse_args(["-m", str(model), "-q", "--device",
                                      device])
    with first_segments(keep_cubes=True) as firsts:
        trace_segment.launches = 0
        t0 = time.perf_counter()
        omega_pe, grid, rec = trace_demo_rays(args)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
    n_seg = len(segment_plan(args.n_steps, args.record_stride, 64)[0])
    lo, hi = args.grid_min, args.grid_max
    inside = np.all((rec >= lo) & (rec <= hi), axis=2)
    say(f"[11] demo_rays {args.grid_n}^3, {args.n_rays} rays x "
        f"{args.n_steps} steps, cross-sections off: {wall:.3f} s; records "
        f"{rec.shape}, finite {np.isfinite(rec).mean():.5f}, inside the "
        f"cube {inside.mean():.5f}; x span {np.ptp(rec[:, :, 0]):.4f} R_sun;"
        f" kernel launches {launches} = segments {n_seg}")
    assert launches == n_seg, launches
    assert np.isfinite(rec).all(), "a frozen ray's position went NaN"
    assert np.ptp(rec[:, :, 0]) > 1.0
    hold_segment("11", "demo_rays' first segment, cross-sections off",
                 firsts[0], 1.0)
    del omega_pe, firsts

    out_dir = Path(tmp) / "cmp_s"
    trace_segment.launches = 0
    t0 = time.perf_counter()
    say("[11] compare_s_input (100^2 pixels, 150^3, 60 MHz, 5000 steps), "
        "its statistics:")
    compare_s_input.main(["-m", str(model), "-o", str(out_dir), "--no-plot",
                          "-q", "--device", device])
    wall = time.perf_counter() - t0
    n_seg = 2 * len(segment_plan(5000, 10, 64)[0])
    say(f"[11] compare_s_input: {wall:.3f} s; kernel launches "
        f"{trace_segment.launches} = 2 maps x segments")
    assert trace_segment.launches == n_seg, trace_segment.launches
    for name in ("on", "off"):
        tb = np.load(out_dir / f"ray_tracing_compare_s_{name}.npz")
        assert np.all(np.isfinite(tb["emission_cube"])), name

    t0 = time.perf_counter()
    plane = sample_plane(MASModel(model), n_pix=512, device=device)
    wall = time.perf_counter() - t0
    for key in ("ne", "te", "b"):
        assert plane[key].shape == (512, 512), key
        assert np.all(np.isfinite(plane[key]) & (plane[key] > 0)), key
    say(f"[11] sample_plane 512^2: {wall:.3f} s; ne "
        f"{plane['ne'].min():.4g}..{plane['ne'].max():.4g} cm^-3, te "
        f"{plane['te'].min():.4g}..{plane['te'].max():.4g} K, |B| "
        f"{plane['b'].min():.4g}..{plane['b'].max():.4g} G")


# phase 12's bar on a mesh map against the one-process map: every ray
# runs the same per-thread arithmetic in whatever shard it is
MESH_TB_RTOL, MESH_VI_ATOL = 1e-6, 1e-6


def hold_mesh_map(tag, ranks, one, n_seg):
    """Every rank's map against the one-process map `one` under the mesh
    bar, each rank's launches = segments; prints each rank's stages."""
    d_tb = d_vi = 0.0
    for r in sorted(ranks, key=lambda r: r["rank"]):
        t = r["timings"]
        say(f"[12] {tag} rank {r['rank']} {r['coords']}: wall "
            f"{r['wall']:.3f} s; resample {t['resample']:.4f} s, trace "
            f"{t['trace']:.4f} s, transfer {t['transfer']:.4f} s, gather "
            f"{t['gather']:.4f} s, finish {t['finish']:.4f} s; kernel "
            f"launches {r['launches']} = segments {n_seg}")
        assert r["launches"] == n_seg == t["segments"], r["launches"]
        tb, vi = r["emission_cube"], r["emission_polVI_cube"]
        ref_tb, ref_vi = one["emission_cube"], one["emission_polVI_cube"]
        assert tb.shape == ref_tb.shape and np.all(np.isfinite(tb))
        d_tb = max(d_tb, float(np.max(np.abs(tb - ref_tb)
                                      / np.maximum(np.abs(ref_tb), 1e-30))))
        d_vi = max(d_vi, float(np.max(np.abs(vi - ref_vi))))
    t = ranks[0]["timings"]
    say(f"[12] {tag}: straggler factor {t['straggler_factor']} (live steps "
        f"per ray shard {t['shard_live_steps']}); vs one process max rel "
        f"|dT_b| {d_tb:.3g}, max |dV/I| {d_vi:.3g}")
    assert d_tb <= MESH_TB_RTOL and d_vi <= MESH_VI_ATOL, (d_tb, d_vi)
    return {"straggler": t["straggler_factor"], "max_rel_tb": d_tb,
            "max_vi": d_vi, "ranks": ranks}


# phase 12's torchrun script: the README's multi-device example with its
# devices and backend named, so that two ranks share one card over gloo.
# Each rank pickles its map, coordinates, stages and kernel launches; rank
# 0 alone writes out_path, as in the example.
TORCHRUN_SCRIPT = """\
import json, pickle, sys, time
import torch.distributed as dist
from raytracinggrff_tpu_torch import (RayEmissionConfig, make_mesh,
                                      run_ray_tracing_emission)
from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment

model_path, out_dir = sys.argv[1], sys.argv[2]
config, devices = json.loads(sys.argv[3]), json.loads(sys.argv[4])
mesh = make_mesh(n_ray_shards=2, devices=devices, backend="gloo")
timings = {}
trace_segment.launches = 0
t0 = time.perf_counter()
result = run_ray_tracing_emission(
    model_path=model_path, config=RayEmissionConfig(**config), mesh=mesh,
    device=mesh.device, out_path=f"{out_dir}/map.npz", verbose=False,
    timings=timings)
wall = time.perf_counter() - t0
with open(f"{out_dir}/rank{mesh.rank}.pkl", "wb") as f:
    pickle.dump({"rank": mesh.rank, "coords": (mesh.ray_index,
                                               mesh.freq_index),
                 "emission_cube": result["emission_cube"],
                 "emission_polVI_cube": result["emission_polVI_cube"],
                 "wall": wall, "timings": timings,
                 "launches": trace_segment.launches}, f)
dist.destroy_process_group()
"""


def torchrun_map(tmp, model, cfg, device):
    """The production map over a (2, 1) mesh from `python -m
    torch.distributed.run --standalone --nproc-per-node 2`: make_mesh's
    env:// rendezvous, both ranks on `device` over gloo. Returns the
    ranks' results and rank 0's out_path map."""
    import dataclasses
    import pickle
    from raytracinggrff_tpu_torch.parallel import launch
    out = Path(tmp) / "torchrun"
    out.mkdir()
    script = out / "emission.py"
    script.write_text(TORCHRUN_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent),
               OMP_NUM_THREADS="1")
    devices = [str(launch.rank_devices(device, 1)[0])] * 2
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), str(model), str(out),
         json.dumps(dataclasses.asdict(cfg)), json.dumps(devices)],
        cwd=out, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, (proc.returncode, proc.stdout[-4000:],
                                  proc.stderr[-4000:])
    say(f"[12] torchrun --standalone --nproc-per-node 2, devices {devices}, "
        f"gloo: exit code 0, {wall:.3f} s from start to exit")
    ranks = [pickle.loads((out / f"rank{r}.pkl").read_bytes())
             for r in (0, 1)]
    return ranks, dict(np.load(out / "map.npz"))


def phase_mesh(tmp, one, device="cuda", backend="gloo",
               shapes=((2, 1), (2, 2)), **overrides):
    """The production map (SLICE with `overrides`) over meshes, against
    phase 4's map `one`: (1, 1) in this process, then each of `shapes` as
    spawned ranks on `device` ("cuda" deals them over the cards) with
    `backend` (None: nccl on CUDA), with nfreq 4 where the frequency axis
    is sharded; then (2, 1) from torchrun (torchrun_map); then
    dryrun_multichip over the most ranks. The card machine has one H100,
    and NCCL refuses two ranks on one device, so here the ranks share
    cuda:0 over gloo."""
    import dataclasses
    import torch.distributed as dist
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.parallel import dryrun, launch, mesh
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   run_ray_tracing_emission)
    model = synthetic_mas_model(Path(tmp) / "corona_mesh", timestep=2)
    cfg = RayEmissionConfig(**dict(SLICE, **overrides))
    n_seg = n_segments(cfg)
    first = launch.rank_devices(device, 1)[0]
    group_backend = mesh.default_backend(first)
    launch.init_group(Path(tmp) / "store", 0, 1, group_backend)
    try:
        r = dryrun.map_rank([first], (1, 1), cfg, model_path=model)
    finally:
        dist.destroy_process_group()
    out = {(1, 1): hold_mesh_map(f"(1, 1) {group_backend}, in process", [r],
                                 one, n_seg)}
    cfg4 = dataclasses.replace(cfg, nfreq=4)
    one4 = None
    for shape in shapes:
        c, ref = cfg, one
        if shape[1] > 1:
            if one4 is None:
                one4 = run_ray_tracing_emission(model_path=model,
                                                config=cfg4, verbose=False,
                                                device=first)
            c, ref = cfg4, one4
        t0 = time.perf_counter()
        ranks = launch.spawn(dryrun.map_rank, shape[0] * shape[1], device,
                             backend, args=(shape, c, None, model))
        say(f"[12] {shape}: spawn to results {time.perf_counter() - t0:.3f}"
            f" s")
        out[shape] = hold_mesh_map(
            f"{shape} {backend or 'nccl'}, spawned, nfreq {c.nfreq}", ranks,
            ref, n_seg)
    ranks, saved = torchrun_map(tmp, model, cfg, device)
    out["torchrun"] = hold_mesh_map("(2, 1) gloo, torchrun", ranks, one,
                                    n_seg)
    for key in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(saved[key], ranks[0][key])
    n = max(a * b for a, b in shapes)
    t0 = time.perf_counter()
    summary = dryrun.dryrun_multichip(n, device=device, backend=backend)
    for r in summary["ranks"]:
        assert r["launches"] == r["timings"]["segments"], r["launches"]
    say(f"[12] dryrun_multichip({n}): {time.perf_counter() - t0:.3f} s; "
        f"kernel launches per rank {[r['launches'] for r in summary['ranks']]}"
        f" = segments; "
        f"map max |dT_b| {summary['max_abs_tb']:.3g} K, |dV/I| "
        f"{summary['max_abs_vi']:.3g}; straggler factor "
        f"{summary['straggler_factor']}")
    out["dryrun"] = summary
    return out


def phase_float64(tmp, device="cuda"):
    """Phase 5's map through the kernel (n_pix 32 x 600 steps, nfreq 2, S
    input on, mechanism 5) against the float64 reference: the same records
    (trace_rays_segments) as LOS columns with the streamed path's validity
    and ds (sampler.los_from_records), S x pixel area as the source areas,
    through grff/reference.grff_transfer_reference on the host. Bar: lit
    on-disk T_b within 1% (PERF.md section 1)."""
    from raytracinggrff_tpu_torch.constants import R_SUN_CM
    from raytracinggrff_tpu_torch.grff.reference import (
        grff_transfer_reference)
    from raytracinggrff_tpu_torch.grff.transfer import (log_spaced_freqs,
                                                        tb_from_sfu)
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   image_ray_starts,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    from raytracinggrff_tpu_torch.sampler import los_from_records
    from raytracinggrff_tpu_torch.tracer_segments import trace_rays_segments
    grid = UniformGrid.cube(3.0, 128)
    cubes = prepare_cubes(MASModel(synthetic_mas_model(Path(tmp) / "c64")),
                          grid, 0.0, verbose=False, device=device)
    cfg = RayEmissionConfig(**dict(SLICE, n_pix=32, n_steps=600, nfreq=2))
    tb = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                  device=device)["emission_cube"]
    _, _, start, kdir = image_ray_starts(cfg.n_pix, cfg.x_fov,
                                         cfg.z_observer)
    t0 = time.perf_counter()
    tr = trace_rays_segments(cubes["omega_pe"], cubes["ne"], cubes["te"],
                             cubes["b"], grid, cfg.freq_hz, start, kdir,
                             cfg.dt, cfg.n_steps, cfg.record_stride, True,
                             cfg.perturb_ratio, cfg.seg_records)
    los = los_from_records(*(torch.as_tensor(a) for a in (
        tr.r_record, tr.s_record, tr.ne, tr.te, tr.b, start)))
    area = ((2 * cfg.x_fov) / cfg.n_pix * R_SUN_CM) ** 2
    freqs = log_spaced_freqs(cfg.freq0, cfg.nfreq, cfg.freq_log_step)
    ref = grff_transfer_reference(
        los.ds, los.te, los.ne, los.b, los.valid_mask, freqs, area,
        s_area_cm2=los.s.double() * area, theta_deg=cfg.theta_deg,
        mechanism=cfg.mechanism, gaunt=cfg.gaunt)
    tb_ref = tb_from_sfu(ref["flux_o"] + ref["flux_x"], freqs[None, :],
                         area).reshape(tb.shape)
    wall = time.perf_counter() - t0
    lit = disk_mask(cfg.n_pix, cfg.x_fov)[:, :, None] & (tb_ref > 1e4)
    rel = np.abs(tb[lit] - tb_ref[lit]) / tb_ref[lit]
    say(f"[13] float64 reference ({wall:.3f} s on the host, "
        f"{tr.r_record.shape[0]} records x {start.shape[0]} rays x "
        f"{cfg.nfreq} frequencies): {lit.sum()} lit on-disk values, max rel "
        f"T_b diff {rel.max():.4g}, median {np.median(rel):.4g} (bar 0.01)")
    assert lit.sum() > 100 and rel.max() <= 0.01, rel.max()
    return {"max_rel": float(rel.max()), "lit": int(lit.sum())}


def fma_trace(libs, n_pix=256, n_steps=5000):
    """Phase 14 (a) and (b): the canonical trace (n_pix^2 x n_steps x 128^3
    at 75 MHz) through the FMA build and the shipped build (`libs`, by
    those names) in lockstep, every record compared segment by segment
    under ROW_TOL, with the first rays to part and where; the first
    segment timed through each in turns (FMA, shipped, shipped, FMA); then
    the shipped build's last segment against the plain version from the
    same state, record rows 0-6 bit for bit. The one assertion of (a) is
    that no record value is NaN in one build and finite in the other."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs,
                                                          segment_plan)
    grid, f, start, kdir = canonical_scene(n_pix)
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state_f = state_s = initial_state(tcube, grid, 75e6, start, kdir)
    first = (tcube, scube, state_s, grid, 6e-3, 1, 10, 64)
    ms = {"fma": [], "shipped": []}
    for name in ("fma", "shipped", "shipped", "fma"):
        with kernel_library(libs[name]):
            ms[name].append(cuda_ms(lambda: trace_segment(*first), reps=5))
    say(f"[14] (a) first segment ({n_pix ** 2} rays x 631 steps) in turns: "
        f"FMA build {['%.4f' % t for t in ms['fma']]} ms, shipped "
        f"{['%.4f' % t for t in ms['shipped']]} ms")
    plan, _ = segment_plan(n_steps, 10, 64)
    n_rays = state_s.shape[1]
    every = torch.ones(n_rays, dtype=torch.bool, device=state_s.device)
    parted_at = torch.full((n_rays,), -1, device=state_s.device)
    parted, nan_parted, shares, rec0 = [], 0, [], 0
    for i, (n_first, rps) in enumerate(plan):
        before = state_s
        state_s, rec_s = trace_segment(tcube, scube, state_s, grid, 6e-3,
                                       n_first, 10, rps)
        with kernel_library(libs["fma"]):
            state_f, rec_f = trace_segment(tcube, scube, state_f, grid,
                                           6e-3, n_first, 10, rps)
        ok, worst = record_agreement(rec_f, rec_s)
        every &= ok.all(dim=0)
        nan_parted += int((torch.isnan(rec_f) != torch.isnan(rec_s)).sum())
        new = (parted_at < 0) & ~ok.all(dim=0)
        bad_at = (~ok).int().argmax(dim=0)
        parted_at = torch.where(new, rec0 + bad_at, parted_at)
        for ray in torch.nonzero(new)[:6 - len(parted), 0].tolist():
            r = int(bad_at[ray])
            parted.append((ray, rec0 + r, rec_f[r, :7, ray].tolist(),
                           rec_s[r, :7, ray].tolist()))
        rec0 += rps
        shares.append(float(ok[-1].double().mean()))
        say(f"[14] (a) segment {i} ({n_first} + {rps - 1} x 10 steps): FMA "
            f"vs shipped, {shares[-1]:.5f} of rays within tolerance at its "
            f"last record, {float(every.double().mean()):.5f} at every "
            f"record so far; max |diff| per row "
            f"{['%.3g' % w for w in worst]}")
    dr = (rec_f[-1, 0:3] - rec_s[-1, 0:3]).double().norm(dim=0)
    dr = dr[torch.isfinite(dr)].cpu().numpy()
    p50, p99 = np.percentile(dr, [50, 99])
    at = parted_at[parted_at >= 0].cpu().numpy()
    where = np.percentile(at, [0, 50, 100]).tolist() if at.size else []
    say(f"[14] (a) whole trace: {float(every.double().mean()):.5f} of "
        f"{n_rays} rays within tolerance at every record; {at.size} parted, "
        f"at records {where} (min, median, max); |dr| at the final record "
        f"over {dr.size} rays "
        f"with a finite position: p50 {p50:.4g}, p99 {p99:.4g}, max "
        f"{dr.max():.4g} R_sun; record values NaN in one build only: "
        f"{nan_parted}")
    for ray, rec, a, b in parted:
        say(f"[14] (a) ray {ray} (pixel {ray // n_pix}, {ray % n_pix}) parts "
            f"at record {rec} (step {1 + 10 * rec}): rows x, y, z, S, ne, "
            f"te, b {['%.7g' % v for v in a]} (FMA) vs "
            f"{['%.7g' % v for v in b]} (shipped)")
    assert nan_parted == 0, nan_parted

    n_first, rps = plan[-1]
    _, rec_p = trace_segment_plain(tcube, scube, before, grid, 6e-3, n_first,
                                   10, rps)
    a, b = rec_s[:, :7], rec_p[:, :7]
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    say(f"[14] (b) last segment ({n_first} + {rps - 1} x 10 steps from the "
        f"shipped build's state): shipped build vs plain, rows 0-6 "
        f"{int(same.sum())} of {same.numel()} values bit for bit; rows "
        f"unequal {sorted(set(torch.nonzero(~same)[:, 1].tolist()))}")
    assert same.all(), "the shipped build parted from the plain version"
    return {"ms": ms, "last_record_shares": shares,
            "every_record_share": float(every.double().mean()),
            "parted": int(at.size), "dr": (float(p50), float(p99),
                                           float(dr.max()))}


def phase_fma(tmp, fma_lib):
    """Phase 14: the FMA build (FMA_NVCC_FLAGS) against the shipped build
    (NVCC_FLAGS, -fmad=false) over whole traces: fma_trace, then (c) the
    production map (phase 4's model and SLICE) and the sweep map at index
    29 (800 MHz, 576^3, 3,000 records) through both builds, against
    DV_BAR_FIXED in |dV/I| and 5e-3 in relative T_b over lit on-disk
    values, with the worst pixels. Where the FMA build misses a bar, the
    shipped build must be the exact one."""
    from raytracinggrff_tpu_torch.cli.tb_spectra import (run_sweep,
                                                         sweep_frequencies)
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    libs = {"fma": fma_lib, "shipped": ts._library()}
    out = fma_trace(libs)
    model = synthetic_mas_model(Path(tmp) / "corona_fma", timestep=2)
    cubes = prepare_cubes(MASModel(model), UniformGrid.cube(3.0, 128), 0.0,
                          verbose=False, device="cuda")
    maps = {}
    for name, lib in libs.items():
        with kernel_library(lib):
            maps[name] = run_ray_tracing_emission(
                cubes=cubes, config=RayEmissionConfig(**SLICE),
                verbose=False, device="cuda")
    del cubes
    out["production"] = map_diff(
        "14", "(c) production map 256^2 x 5000 x 128^3, FMA vs shipped",
        maps["shipped"], maps["fma"], DV_BAR_FIXED, disk_mask(256, 1.44))
    worst_pixels("14", maps["shipped"], maps["fma"])
    sweep_model = synthetic_mas_model(Path(tmp) / "corona_fma_sweep")
    freqs = sweep_frequencies()[[29]]
    for name, lib in libs.items():
        timings = []
        with kernel_library(lib):
            rows = run_sweep(sweep_model, freqs, Path(tmp) / f"fma_{name}",
                             n_pix=128, phi0_offset=-140.0, device="cuda",
                             timings=timings, verbose=False)
        maps[name] = dict(np.load(rows[0]["npz"]))
    t = timings[0]
    out["sweep29"] = map_diff(
        "14", f"(c) sweep index 29 ({t['freq_hz'] / 1e6:.1f} MHz, "
        f"{t['grid_n']}^3, {t['records']} records), FMA vs shipped",
        maps["shipped"], maps["fma"], DV_BAR_FIXED,
        disk_mask(128, t["x_fov"]))
    worst_pixels("14", maps["shipped"], maps["fma"])
    held = out["production"]["held"] and out["sweep29"]["held"]
    say(f"[14] (c) the FMA build {'holds' if held else 'misses'} the map "
        f"bars; shipped nvcc flags end in {ts.NVCC_FLAGS[-1]}")
    assert held or "-fmad=false" in ts.NVCC_FLAGS
    return out


def phase_harness():
    """Phase 15: the port's benchmark harness (bench_torch.py) in this
    process at the canonical size, trace and pipeline mode, --repeat 3;
    each prints its JSON line. Every run (one warm-up, three repeats)
    launches the kernel once per segment."""
    from raytracinggrff_tpu_torch import harness
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    out = {}
    for mode in ([], ["--pipeline"]):
        trace_segment.launches = 0
        res = harness.main(["--repeat", "3", *mode])
        launches = trace_segment.launches
        say(f"[15] harness {res['metric']}: {res['value']:.6g} "
            f"{res['unit']}, median of {res['times_s']}; kernel launches "
            f"{launches} = 4 runs x 8 segments")
        assert launches == 4 * 8, launches
        assert np.isfinite(res["value"]) and res["value"] > 0
        assert {"gpu", "power_limit"} <= set(res["workload"])
        out[res["metric"]] = res
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t_all = time.perf_counter()
    fma_lib = phase_build()
    with torch.inference_mode():
        phase_small(out)
        phase_canonical(out)
        with tempfile.TemporaryDirectory() as tmp:
            one = phase_main(out, tmp)
        cubes = phase_map()
        with tempfile.TemporaryDirectory() as tmp:
            phase_los(tmp)
            phase_gyro(tmp)
            phase_compare(tmp)
        phase_per_step(out, cubes)
        del cubes
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phase_sweep(tmp)
            phase_cli(tmp)
            phase_mesh(tmp, one)
            phase_float64(tmp)
            phase_fma(tmp, fma_lib)
        phase_harness()
    say(f"total {time.perf_counter() - t_all:.1f} s")
    say(json.dumps({"kernels": [{
        "name": "trace_segment", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": out["launches"],
        "max_abs_err": out["max_abs_err"], "ms": out["ms"],
        "plain_ms": out["plain_ms"], "bound_ms": out["bound_ms"],
        "bound_by": out["bound_by"], "library_ms": None,
        "bound_share": out["bound_ms"] / out["ms"]}]}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
