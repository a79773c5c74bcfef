#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Builds the kernel library from raytracinggrff_tpu_torch/csrc (the trace
segment, the two transfer folds, the MAS resample and spherical sampler,
and the two line-of-sight scans), holds the trace kernel against its
plain PyTorch version on the card, drives the production
emission map (256^2 rays x 5000 steps x 128^3 cube at 75 MHz, nfreq 3,
cross-sections and S input on) through run_ray_tracing_emission, and checks
the map; then drives the straight-LOS chain, the gyroresonance map, the
low-band LOS vs ray-tracing comparison, per-step cross-sections, three
maps of the TbSpectra sweep, the other device CLIs at the defaults of
their CLIs, the production map over multi-device meshes (spawned and from torchrun), a
map against the float64 transfer reference, the kernel against the plain
version at the end of a whole trace, the benchmark harness,
a MAS time series stepped through MASModel.at_time, the transfer folds
against their plain versions, alone and inside whole maps, the
resample, sampler and scan kernels against theirs, and the record fold's
counts against a plain count.
Phases:
  1. versions, card, kernel build: the one library (NVCC_FLAGS,
     -fmad=false) in one nvcc call, with ptxas's registers and spills
  2. kernel vs plain on a non-reflecting scene, every ray within tolerance
  3. kernel vs plain on the canonical scene's first segment (>= 99% of
     rays within tolerance), with both times and the kernel's bound; then
     the canonical trace's eight segments one by one, each with the rays
     frozen at its launch (k not finite), its live records, its time and
     its bound, and the first segment that starts with frozen rays held
     to the plain version bit for bit (records rows 0-6 and the state)
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
 14. the canonical trace (256^2 x 5000 steps x 128^3, 8 segments)
     through the kernel, and its last segment against the plain version
     from the same state: record rows 0-6 bit for bit
 15. the benchmark harness (bench_torch.py) at the canonical size, trace
     and pipeline mode, --repeat 3: its two JSON lines, 32 launches each
 16. a MAS time series: one directory with two timesteps (the second
     unmodulated, so ne differs), n_timesteps 2 for each variable; per
     step, prepare_cubes(model.at_time(i)) at 128^3 and the production
     map on those cubes, with its stage times, equal to the
     model_path=..., timestep=i map exactly, on-disk T_b in 1e4..3e6 K;
     the two maps differ by more than 1e-3 relative on-disk T_b; step
     1's cubes kernel vs plain at n_pix 32 under DV_BAR_FIXED
 17. the transfer folds (csrc/transfer_fold.cu): (a) the record fold on
     the canonical scene's first segment (65,536 rays x 64 records, nfreq
     3, S input on, B 5-20 G) through the kernel and the plain version,
     mechanisms 1, 5 and 7 at a fixed theta and with theta_mode 'los',
     mechanism 5 at a fixed theta at Nf 1, 5 and 9, and mechanism 7 at
     s_max 200 (above the former cap of 128 harmonics); (a') the record
     fold at the sweep's size (16,384 rays x 64 records, Nf 1, mechanism
     5). Each fold is held to its plain version (hold_fold): carries
     equal (torch.equal) without gyroresonance, flux max rel 1e-4 over
     entries above 1e-30 with it, and the evanescent (tau = inf) sets
     equal on every (ray, frequency) entry, with each fold's time, its
     plain time and its bound; (b) the production map and the
     gyroresonance map of phase 7 with their transfer through the kernel
     and through the plain fold: rel T_b 5e-3 and DV_BAR_FIXED, or
     DV_BAR_GR; (c) the LOS chain's synthetic_ff (phase 6's size) through
     the voxel fold and the plain one under DV_BAR_FIXED, and its fold
     alone timed both ways with its bound
 18. the scene kernels (csrc/resample_sph.cu, csrc/los_scans.cu) against
     their plain versions: (a) the cube resample of the synthetic model's
     five variables in one launch at 128^3 (phi0 0) and at the sweep's
     largest set, 576^3 at extent 1.5 (phi0 -140), and of a staggered
     scene of its five variables at 128^3, with fill None and 0: every
     variable's NaN mask equal and every other voxel within
     RESAMPLE_ULP_BAR ulps; the five-variable launch and one variable's
     launch timed at each size; prepare_cubes' four cubes, and the
     production map from kernel cubes against the map from plain cubes
     under the map bars; (b) resample_mas_los at phase 6's shapes through
     the spherical sampler and the plain one (Ne, Te, B as in (a)), the
     sampler's five-variable launch and one variable's timed; (c) the ds
     scan on the canonical scene's first segment (65,536 rays x 64
     records), with and without a `usable` mask,
     and pipeline._center_los with and without cos theta: valid and ds
     equal (torch.equal), the scan timed; (d) get_mw in DEM mode (200
     voxels, 100 frequencies, 50 temperatures), free-free and with
     gyroresonance, through the DEM-scan kernel and the plain recurrence:
     RL equal, the scan alone timed
 19. the record fold's counts (ops/transfer_fold.fold_counts, kernel
     rgrff_fold_counts): on fold_scene's canonical gyroresonance segment
     (65,536 rays x 64 records x 8 rows, B of order 10 G, row 7 cos
     theta(B, k)) and at the sweep's 16,384 rays, with theta_mode 'los'
     and without: [stepped from, taken] equal to fold_counts_plain's on
     the same records and the taken ones to fold_records_bound's, one
     launch a call, timed; then phase 7's gyroresonance map (256^2 x 5000
     x 128^3, 11 frequencies) under torch.profiler: one count launch a
     segment, each segment's counts equal to fold_counts_plain's on the
     records its fold was given, and the map equal to the untraced one
 20. the trace-input kernel (rgrff_pack_trace_inputs) against
     pack_trace_inputs_plain on the card at 128^3 (the canonical cube)
     and 576^3 (the sweep's largest), with 4 and 8 sample channels: trace
     and sample cubes equal bit for bit, one launch a call, each timed
     beside its bound (PACK_BYTES a voxel at PEAK_BYTES_S)
 21. compare_los_raytracing's 800 MHz high-band preset
     (HIGHBAND_PRESETS[800e6], as the benchmark's compare_800mhz cell runs
     it): 128^2 rays x 12,000 steps at stride 5 on the unrounded 520^3
     cube, and the LOS map at 128^2 x 1,100 voxels; its launch counts, and
     each of its kernels held to its plain version on the inputs the run
     gave it and timed beside its bound: the resample of five variables
     onto 520^3 (not a whole number of 16-plane slabs; every cube within
     RESAMPLE_ULP_BAR), the trace's first segment at dt 4e-4 (>= 99% of
     rays within ROW_TOL), the sampler at 18,022,400 points (every
     variable within RESAMPLE_ULP_BAR) and the voxel fold of 1,100 voxels
     x 16,384 pixels x 1 frequency (hold_fold)
Each path that traces rays runs with the launch counts set to 0 just
before it and checks them against its segment count just after: the
trace kernel's and the record fold's, one launch each a segment; a LOS
chain's synthetic_ff launches the voxel fold once, and a map the
trace-input kernel once (phases 4, 10 and 21). Every prepare_cubes
(phases 4, 7, 10, 16, 17, 18 and 21) launches the resample once for its
five variables, resample_mas_los (phases 6, 18 and 21) the spherical
sampler once,
bench's LOS sampling (phase 11) the ds scan once a sampling, and get_mw
in DEM mode the DEM scan once.
The last lines are one JSON object listing the kernels, the card's name
and power
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
FOLD_SOURCE = "raytracinggrff_tpu_torch/csrc/transfer_fold.cu"
# the JAX scans the folds replace: stream_seg and _grff_transfer_jit
FOLD_REPLACES = {"records": "raytracinggrff_tpu/pipeline.py:377",
                 "voxels": "raytracinggrff_tpu/grff/transfer.py:231"}
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
# float32 operations of a valid voxel of csrc/transfer_fold.cu's function,
# counted the same way, with exp, log, pow, sqrt, sin, cos and acos one
# each (negations, selects, clamps and compares not counted), each term
# where it first depends on its inputs: once a record, once a voxel for the
# terms that no frequency enters, once a (voxel, frequency) for the terms
# that no mode enters, and the rest once a mode; a subexpression that
# recurs is counted once. Once a record: ds from the last valid position
# 10, S x area 1 (s_on), acos/sin/cos 3 (theta per record); once a voxel
# with a per-voxel theta: sin and cos 2. Then (once a voxel, once a
# (voxel, frequency)):
#   common (5, 45): area, nu_p^2, nu_B, T x area, nu_B |cos theta|; X, Y,
#     the source 1, n^2 14 + 4 a mode, and a mode n_sigma 1, eff_nu^2 2,
#     tau 1 and the carry step 6
#   free-free (8, 9 Dulk or 10 exact): ln T, the two Coulomb-log branches
#     but their ln nu 3, coef ne^2 2, T^1.5 2; ln nu twice, the Gaunt
#     scale (exact), x lnLambda, and 3 a mode
#   neutrals (13, 10): the Saha density and collision rate; 5 a mode
#   gyroresonance (11, 64): nu_B', beta^2, beta, the log argument 4,
#     pref x nu_p^2, (cos sin theta)^2 2; Y', pref / nu, the polarization
#     coupling's second n^2 11 + 4 a mode, its Stix terms 7 and 15 a mode,
#     and 3 a mode
#   each harmonic (13, 7): s nu_B, the width 2, the log term 5 and its exp,
#     s nu_B exp, 2 w^2 2, sqrt(2 pi) w; nu - s nu_B, the Gaussian 5, the
#     sum 1
FOLD_FLOPS_RECORD = 10
FOLD_FLOPS_COMMON = (5, 45)
FOLD_FLOPS_FF = {"dulk": (8, 9), "exact": (8, 10)}
FOLD_FLOPS_NEUTRALS = (13, 10)
FOLD_FLOPS_GR, FOLD_FLOPS_HARMONIC = (11, 64), (13, 7)
RESAMPLE_SOURCE = "raytracinggrff_tpu_torch/csrc/resample_sph.cu"
SCAN_SOURCE = "raytracinggrff_tpu_torch/csrc/los_scans.cu"
# the JAX device programs that phase 18's kernels replace: _resample_cube_jit,
# _interp_sph_jit, the ds scan of sample_model_with_rays (and of
# los_from_records) and the voxel scan of _grff_transfer_dem_jit
SCAN_REPLACES = {"resample_cube": "raytracinggrff_tpu/mas/model.py:259",
                 "sample_sph": "raytracinggrff_tpu/mas/model.py:133",
                 "valid_ds": "raytracinggrff_tpu/sampler.py:78",
                 "dem_scan": "raytracinggrff_tpu/grff/transfer.py:425"}
# float32 operations of csrc/resample_sph.cu and csrc/los_scans.cu, counted
# as FOLD_FLOPS_* are: a sample at one point is the fmod 1, three axis
# fractions 3 each, the r bounds 2 and seven lerps 4 each, 40; a cube voxel
# adds r^2 and its root 6, y / r, acos, atan2 and the longitude offset 4,
# 50. A valid record's ds is 10; one DEM step (a voxel, a mode and a
# frequency) an exp, an expm1, two products and two sums, 6.
SAMPLE_FLOPS = 40
RESAMPLE_FLOPS = 50
DS_FLOPS = 10
DEM_FLOPS = 6
# the plain torch ops that the trace-input kernel replaces; it replaces no
# TPU kernel
PACK_REPLACES = "none: torch roll, cat and stack (pack_trace_inputs_plain)"
# bytes a voxel the trace-input kernel moves at least, by sample channels:
# omega_pe, ne, te, b (and Bx, By, Bz) read once, the trace cube's 16 and
# the sample cube's 16 (32) written once
PACK_BYTES = {4: 48, 8: 76}
# phase 18's bar on the resample and sampler kernels against their plain
# versions, in ulps of a float32 value, with equal NaN masks
RESAMPLE_ULP_BAR = 0
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


def device_ms(fn, reps=20):
    """Mean device time in ms of fn()'s launches over reps runs, by CUDA
    events, with the launches queued behind a 25 ms device sleep
    (torch.cuda._sleep) so that they run back to back: the kernels' own
    time, without the host's time to launch them, which cuda_ms includes
    where it is the longer. The median of 5."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


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
def plain_folds():
    """Route the record and voxel folds through their plain versions on
    CUDA tensors for a comparison run; the wrappers themselves never do."""
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    saved = tf.fold_records, tf.fold_voxels
    tf.fold_records = tf.fold_records_plain
    tf.fold_voxels = tf.fold_voxels_plain
    try:
        yield
    finally:
        tf.fold_records, tf.fold_voxels = saved


def reset_counts():
    """Set the launch counts of every kernel to 0: the trace kernel and
    its inputs', both folds, the resample and the spherical sampler, and
    both scans."""
    from raytracinggrff_tpu_torch.ops import los_scans, resample
    from raytracinggrff_tpu_torch.ops.trace_segment import (pack_trace_inputs,
                                                            trace_segment)
    from raytracinggrff_tpu_torch.ops.transfer_fold import LAUNCHES
    trace_segment.launches = 0
    pack_trace_inputs.launches = 0
    for counts in (LAUNCHES, resample.LAUNCHES, los_scans.LAUNCHES):
        counts.update(dict.fromkeys(counts, 0))


def check_kernel(tag, module, kind, n, device="cuda"):
    """The launches of ops.`module` ('transfer_fold', 'resample' or
    'los_scans') entry `kind` since reset_counts equal n on a card; the CPU
    runs the plain versions, which count none. Returns the count."""
    import importlib
    counts = importlib.import_module(
        f"raytracinggrff_tpu_torch.ops.{module}").LAUNCHES
    got = counts[kind]
    want = n if torch.device(device).type == "cuda" else 0
    assert got == want, (tag, module, kind, got, want)
    return got


def check_folds(tag, kind, n, device="cuda"):
    """check_kernel of fold_`kind` ('records' or 'voxels')."""
    return check_kernel(tag, "transfer_fold", kind, n, device)


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


def phase_build():
    """Build the kernel library (NVCC_FLAGS) and print ptxas's registers
    and spills for each kernel."""
    from raytracinggrff_tpu_torch.ops import _build
    say(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    say(f"nvidia-smi: {smi_line()}")
    t0 = time.perf_counter()
    _, log = _build.build_library()
    for line in log.splitlines():
        if "Compiling" in line or "spill" in line or "registers" in line:
            say(f"[build] ptxas: {line.strip()}")
    _build.library()
    say(f"[1] built the kernel library in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


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


def bound(ops, nbytes):
    """(ms, "operations" or "bytes"): the larger of ops at PEAK_F32_FLOPS
    and nbytes at PEAK_BYTES_S."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


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
    return bound(ops, nbytes)


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


def phase_segments(out, n_pix=256, n_steps=5000):
    """Phase 3 (b): the canonical trace (n_pix^2 rays x 4,991 steps) segment
    by segment, each launch timed (cuda_ms, 5 launches from its own input
    state) beside the rays whose k is not finite at its launch (their lanes
    stop within two steps), the share of its last record's rays that are
    live (S > 0) and segment_bound_ms; segment 0 is phase 3's control. The
    first segment that starts with frozen rays, live lanes beside frozen
    ones, is held to the plain version: records rows 0-6 and the state bit
    for bit."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs,
                                                          segment_plan)
    grid, f, start, kdir = canonical_scene(n_pix)
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    plan, _ = segment_plan(n_steps, 10, 64)
    rows, held = [], False
    for i, (n_first, rps) in enumerate(plan):
        args = (tcube, scube, state, grid, 6e-3, n_first, 10, rps)
        frozen = int((~torch.isfinite(state[3:6])).any(dim=0).sum())
        ms = cuda_ms(lambda: trace_segment(*args), reps=5)
        st_k, rec_k = trace_segment(*args)
        bound_ms, _ = segment_bound_ms(tcube, scube, state, rec_k, n_first,
                                       10)
        live = float((rec_k[-1, 3] > 0).double().mean())
        rows.append(dict(segment=i, frozen=frozen, live_after=live, ms=ms,
                         bound_ms=bound_ms))
        say(f"[3] (b) segment {i} ({n_first} + {rps - 1} x 10 steps): "
            f"{frozen} of {state.shape[1]} rays frozen at launch; live after "
            f"{live:.4f}; kernel {ms:.4f} ms, bound {bound_ms:.4f} ms, "
            f"{bound_ms / ms:.4f} of it")
        if frozen and not held:
            st_p, rec_p = trace_segment_plain(*args)
            a = torch.cat([rec_k[:, :7].flatten(), st_k.flatten()])
            b = torch.cat([rec_p[:, :7].flatten(), st_p.flatten()])
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            say(f"[3] (b) segment {i}, kernel vs plain: records rows 0-6 and "
                f"state {int(same.sum())} of {same.numel()} values bit for "
                f"bit")
            assert same.all(), "the kernel's exit parted from the plain"
            held = True
        state = st_k
    assert held, "no segment started with frozen rays"
    total = sum(r["ms"] for r in rows)
    say(f"[3] (b) whole trace: {total:.3f} ms in {len(rows)} launches "
        f"({n_pix ** 2 * steps_run(n_steps, 10) / total * 1e3:.4g} "
        f"ray-steps/s)")
    out["segments"] = rows


def phase_main(out, tmp):
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.ops.trace_segment import (pack_trace_inputs,
                                                            trace_segment)
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   run_ray_tracing_emission)
    model = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
    cfg = RayEmissionConfig(**SLICE)
    npz = Path(tmp) / "ray_tracing_emission.npz"
    n_seg = n_segments(cfg)
    steps = steps_run(cfg.n_steps, cfg.record_stride)
    for run in (1, 2):
        timings = {}
        reset_counts()
        t0 = time.perf_counter()
        res = run_ray_tracing_emission(model_path=model, config=cfg,
                                       out_path=npz, verbose=False,
                                       device="cuda", timings=timings)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
        assert launches == n_seg == timings["segments"], (launches, n_seg)
        assert pack_trace_inputs.launches == 1, pack_trace_inputs.launches
        folds = check_folds("4", "records", n_seg)
        resamples = check_kernel("4", "resample", "cube", 1)
        rate = 256 * 256 * steps / timings["trace"]
        say(f"[4] run {run}: wall {wall:.3f} s; resample "
            f"{timings['resample']:.4f} s, trace {timings['trace']:.4f} s "
            f"({rate:.4g} ray-steps/s over {steps} steps), transfer "
            f"{timings['transfer']:.4f} s, finish {timings['finish']:.4f} s;"
            f" kernel launches {launches} = segments {n_seg}, trace-input "
            f"launches 1, record-fold launches {folds}, resample launches "
            f"{resamples}")
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
    out.update(launches=launches, pack_launches=1, fold_launches=folds,
               resample_launches=resamples, wall=wall, timings=timings)
    return res


def map_kernel_vs_plain(tag, cubes, bar, device="cuda", **overrides):
    """The n_pix 32 x 600-step map through the kernels (trace and record
    fold) and through their plain versions on the same cubes: rel T_b <=
    5e-3 (the bar of
    tests/test_streamed_pipeline.py) and |dV/I| within `bar`, one of
    DV_BAR_FIXED and DV_BAR_GR."""
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   run_ray_tracing_emission)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    cfg = RayEmissionConfig(**dict(SLICE, n_pix=32, n_steps=600, nfreq=2,
                                   **overrides))
    reset_counts()
    r_k = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                   device=device)
    launches = trace_segment.launches
    assert launches == n_segments(cfg), (launches, n_segments(cfg))
    check_folds(tag, "records", n_segments(cfg), device)
    with plain_segments(), plain_folds():
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
    cli/synthetic_ff.py: no rays are traced, and synthetic_ff launches the
    voxel fold once. Returns its stage times, the LOS data and the map."""
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.pipeline import (resample_mas_los,
                                                   synthetic_ff)
    model = synthetic_mas_model(Path(tmp) / "corona_los")
    reset_counts()
    t0 = time.perf_counter()
    los = resample_mas_los(model, n_pix=n_pix, x_range=(-1.44, 1.44),
                           y_range=(-1.44, 1.44), n_z=400, dz0=3e-4,
                           phi0_offset=24.0, verbose=False, device=device)
    t1 = time.perf_counter()
    samples = check_kernel("6", "resample", "sph", 1, device)
    em = synthetic_ff(los, 450e6, 4, 0.1, verbose=False, device=device)
    t2 = time.perf_counter()
    folds = check_folds("6", "voxels", 1, device)
    say(f"[6] resample_mas_los {n_pix}^2 x 400 ({n_pix ** 2 * 400} samples "
        f"per variable): {t1 - t0:.3f} s, spherical-sampler launches "
        f"{samples}; synthetic_ff 4 frequencies from 450 MHz: "
        f"{t2 - t1:.3f} s; voxel-fold launches {folds}")
    tb = em["emission_cube"]
    assert tb.shape == (n_pix, n_pix, 4), tb.shape
    check_disk_tb("6", tb, disk_mask(n_pix, 1.44)[:, :, None].repeat(4, 2))
    return {"resample_s": t1 - t0, "transfer_s": t2 - t1,
            "fold_launches": folds, "sample_launches": samples, "los": los,
            "map": em}


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
    reset_counts()
    t0 = time.perf_counter()
    res = run_ray_tracing_emission(model_path=model, config=cfg,
                                   verbose=False, device=device,
                                   timings=timings)
    wall = time.perf_counter() - t0
    launches = trace_segment.launches
    check_folds("7", "records", n_segments(cfg), device)
    check_kernel("7", "resample", "cube", 1, device)
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
        reset_counts()
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
        check_folds("8", "records", n_segments(cfg), device)
        check_folds("8", "voxels", 1, device)
        ratio = np.median(a[disk]) / np.median(b[disk])
        say(f"[8] {freq / 1e6:.0f} MHz ({p['n_steps']} steps, stride "
            f"{p['record_stride']}, n_z {p['n_z']}): {wall:.3f} s for both "
            f"maps; ray stages resample {timings['resample']:.4f}, trace "
            f"{timings['trace']:.4f}, transfer {timings['transfer']:.4f} s; "
            f"kernel and record-fold launches {launches} = segments "
            f"{n_segments(cfg)}, one voxel fold; "
            f"on-disk median T_b ray/LOS {ratio:.4f}")
        out[freq] = {"wall": wall, "ratio": ratio}
    return out


SWEEP_INDICES = (0, 16, 29)


def phase_sweep(tmp, indices=SWEEP_INDICES, n_pix=128, device="cuda"):
    """The TbSpectra sweep's maps at `indices` of its 30 default
    frequencies, through one run_sweep at the CLI defaults (phi0 -140,
    lattice presets), so that maps that share a cube set reuse it as the
    CLI does. Per map: its preset, stage times and peak device memory,
    every T_b finite, the on-disk median in 1e4..3e6 K and the share of
    on-disk values outside that range; over the run, kernel launches =
    segments. Then each map has its first segment (the sweep's own rays,
    state, stride and records per segment, on its cube set made anew)
    held kernel vs plain as phase 3 holds the canonical one."""
    from raytracinggrff_tpu_torch.cli.tb_spectra import (run_sweep,
                                                         sweep_frequencies)
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.trace_segment import (pack_trace_inputs,
                                                            trace_segment)
    from raytracinggrff_tpu_torch.pipeline import prepare_cubes
    from raytracinggrff_tpu_torch.tracer_segments import prepare_trace_inputs
    model = synthetic_mas_model(Path(tmp) / "corona_sweep")
    freqs = sweep_frequencies()[list(indices)]
    timings = []
    with first_segments() as firsts:
        reset_counts()
        t0 = time.perf_counter()
        rows = run_sweep(model, freqs, Path(tmp) / "mfs", n_pix=n_pix,
                         phi0_offset=-140.0, device=device, timings=timings,
                         verbose=False)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
        packs = pack_trace_inputs.launches
    segments = sum(t["segments"] for t in timings)
    say(f"[10] {len(rows)} map(s): wall {wall:.3f} s; kernel and "
        f"record-fold launches {launches} = segments {segments}; "
        f"trace-input launches {packs}, one a map")
    assert launches == segments, (launches, segments)
    assert packs == len(rows), (packs, len(rows))
    check_folds("10", "records", segments, device)
    sets = {(t["grid_n"], round(t["grid_extent"], 6)) for t in timings}
    resamples = check_kernel("10", "resample", "cube", len(sets), device)
    say(f"[10] resample launches {resamples} = {len(sets)} cube set(s), one "
        f"launch for the five variables of each")
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
    for i, first in zip(indices, firsts):
        grid = first[3]
        cubes = prepare_cubes(MASModel(model), grid, -140.0, verbose=False,
                              device=device)
        tcube, scube = prepare_trace_inputs(cubes["omega_pe"], cubes["ne"],
                                            cubes["te"], cubes["b"], grid)
        del cubes
        hold_segment("10", f"index {i}: first segment", (tcube, scube,
                                                         *first[2:]), 0.99)
        del tcube, scube


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
        reset_counts()
        t0 = time.perf_counter()
        bench.main(["--device", device])
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
    runs = 1 + bench.build_parser().get_default("repeat")
    expect = runs * len(segment_plan(1000, 10, 64)[0])
    scans = check_kernel("11", "los_scans", "valid_ds", runs, device)
    say(f"[11] bench: {wall:.3f} s; kernel launches {launches} = {runs} "
        f"traces x segments; ds-scan launches {scans} = {runs} LOS samplings")
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
    reset_counts()
    t0 = time.perf_counter()
    say("[11] compare_s_input (100^2 pixels, 150^3, 60 MHz, 5000 steps), "
        "its statistics:")
    compare_s_input.main(["-m", str(model), "-o", str(out_dir), "--no-plot",
                          "-q", "--device", device])
    wall = time.perf_counter() - t0
    n_seg = 2 * len(segment_plan(5000, 10, 64)[0])
    say(f"[11] compare_s_input: {wall:.3f} s; kernel launches "
        f"{trace_segment.launches} = record-fold launches = 2 maps x "
        f"segments")
    assert trace_segment.launches == n_seg, trace_segment.launches
    check_folds("11", "records", n_seg, device)
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
    return scans


# phase 12's bar on a mesh map against the one-process map: every ray
# runs the same per-thread arithmetic in whatever shard it is
MESH_TB_RTOL, MESH_VI_ATOL = 1e-6, 1e-6


def hold_mesh_map(tag, ranks, one, n_seg):
    """Every rank's map against the one-process map `one` under the mesh
    bar, each rank's trace and record-fold launches = segments; prints
    each rank's stages."""
    d_tb = d_vi = 0.0
    for r in sorted(ranks, key=lambda r: r["rank"]):
        t = r["timings"]
        say(f"[12] {tag} rank {r['rank']} {r['coords']}: wall "
            f"{r['wall']:.3f} s; resample {t['resample']:.4f} s, trace "
            f"{t['trace']:.4f} s, transfer {t['transfer']:.4f} s, gather "
            f"{t['gather']:.4f} s, finish {t['finish']:.4f} s; kernel "
            f"launches {r['launches']} = record-fold launches "
            f"{r['fold_launches']} = segments {n_seg}")
        assert r["launches"] == n_seg == t["segments"], r["launches"]
        assert r["fold_launches"] == n_seg, r["fold_launches"]
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
# Each rank pickles its map, coordinates, stages and the launches of the
# trace kernel and the record fold; rank
# 0 alone writes out_path, as in the example.
TORCHRUN_SCRIPT = """\
import json, pickle, sys, time
import torch.distributed as dist
from raytracinggrff_tpu_torch import (RayEmissionConfig, make_mesh,
                                      run_ray_tracing_emission)
from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
from raytracinggrff_tpu_torch.ops.transfer_fold import LAUNCHES

model_path, out_dir = sys.argv[1], sys.argv[2]
config, devices = json.loads(sys.argv[3]), json.loads(sys.argv[4])
mesh = make_mesh(n_ray_shards=2, devices=devices, backend="gloo")
timings = {}
trace_segment.launches = LAUNCHES["records"] = 0
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
                 "launches": trace_segment.launches,
                 "fold_launches": LAUNCHES["records"]}, f)
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
        assert r["fold_launches"] == r["launches"], r["fold_launches"]
    say(f"[12] dryrun_multichip({n}): {time.perf_counter() - t0:.3f} s; "
        f"kernel launches per rank {[r['launches'] for r in summary['ranks']]}"
        f" = record-fold launches = segments; "
        f"map max |dT_b| {summary['max_abs_tb']:.3g} K, |dV/I| "
        f"{summary['max_abs_vi']:.3g}; straggler factor "
        f"{summary['straggler_factor']}")
    out["dryrun"] = summary
    return out


def phase_float64(tmp, device="cuda"):
    """Phase 5's map through the kernels (trace and record fold; n_pix 32 x
    600 steps, nfreq 2, S input on, mechanism 5) against the float64
    reference: the same records
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
    reset_counts()
    tb = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                  device=device)["emission_cube"]
    check_folds("13", "records", n_segments(cfg), device)
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


def phase_exact(n_pix=256, n_steps=5000):
    """Phase 14: the canonical trace (n_pix^2 x n_steps x 128^3 at 75 MHz)
    through the kernel segment by segment, then its last segment against
    the plain version from the same state, record rows 0-6 bit for bit."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        trace_segment, trace_segment_plain)
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs,
                                                          segment_plan)
    grid, f, start, kdir = canonical_scene(n_pix)
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    plan, _ = segment_plan(n_steps, 10, 64)
    for n_first, rps in plan:
        before = state
        state, rec = trace_segment(tcube, scube, state, grid, 6e-3, n_first,
                                   10, rps)
    n_first, rps = plan[-1]
    _, rec_p = trace_segment_plain(tcube, scube, before, grid, 6e-3, n_first,
                                   10, rps)
    a, b = rec[:, :7], rec_p[:, :7]
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    say(f"[14] last segment of {len(plan)} ({n_first} + {rps - 1} x 10 "
        f"steps from the kernel's state): kernel vs plain, rows 0-6 "
        f"{int(same.sum())} of {same.numel()} values bit for bit; rows "
        f"unequal {sorted(set(torch.nonzero(~same)[:, 1].tolist()))}")
    assert same.all(), "the kernel parted from the plain version"


def phase_harness():
    """Phase 15: the port's benchmark harness (bench_torch.py) in this
    process at the canonical size, trace and pipeline mode, --repeat 3;
    each prints its JSON line. Every run (one warm-up, three repeats)
    launches the trace kernel once per segment, and in pipeline mode the
    record fold too."""
    from raytracinggrff_tpu_torch import harness
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    out = {}
    for mode in ([], ["--pipeline"]):
        reset_counts()
        res = harness.main(["--repeat", "3", *mode])
        launches = trace_segment.launches
        folds = check_folds("15", "records", 4 * 8 if mode else 0)
        say(f"[15] harness {res['metric']}: {res['value']:.6g} "
            f"{res['unit']}, median of {res['times_s']}; kernel launches "
            f"{launches} = 4 runs x 8 segments, record-fold launches "
            f"{folds}")
        assert launches == 4 * 8, launches
        assert np.isfinite(res["value"]) and res["value"] > 0
        assert {"gpu", "power_limit"} <= set(res["workload"])
        out[res["metric"]] = res
    return out


def phase_series(tmp, device="cuda", **overrides):
    """Phase 16: a MAS time series through MASModel.at_time. One directory
    holds two timesteps, the second unmodulated, so that ne differs. Each
    step's cubes (prepare_cubes(model.at_time(i))) go through the
    production map (SLICE with `overrides`): launches = segments, stage
    times and ray-steps/s printed, the map equal to the model_path=...,
    timestep=i map exactly, on-disk T_b in 1e4..3e6 K. The two steps'
    maps differ by more than 1e-3 relative on-disk T_b, and step 1's
    cubes hold the kernel against the plain version (map_kernel_vs_plain,
    DV_BAR_FIXED)."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    path = synthetic_mas_model(Path(tmp) / "corona_series", timestep=1)
    synthetic_mas_model(path, timestep=2, modulated=False)
    model = MASModel(path)
    counts = {v: model.n_timesteps(v) for v in ("rho", "t", "br", "bt", "bp")}
    say(f"[16] timesteps per variable: {counts}")
    assert set(counts.values()) == {2}, counts
    cfg = RayEmissionConfig(**dict(SLICE, **overrides))
    grid = UniformGrid.cube(cfg.grid_extent, cfg.grid_n)
    disk = disk_mask(cfg.n_pix, cfg.x_fov)[:, :, None].repeat(cfg.nfreq, 2)
    n_seg = n_segments(cfg)
    steps = steps_run(cfg.n_steps, cfg.record_stride)
    maps, out = [], []
    for i in (0, 1):
        reset_counts()
        t0 = time.perf_counter()
        cubes = prepare_cubes(model.at_time(i), grid, cfg.phi0_offset,
                              verbose=False, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        resample = time.perf_counter() - t0
        check_kernel("16", "resample", "cube", 1, device)
        npz = Path(tmp) / f"series_{i}.npz"
        timings = {}
        reset_counts()
        t0 = time.perf_counter()
        res = run_ray_tracing_emission(cubes=cubes, config=cfg, out_path=npz,
                                       verbose=False, device=device,
                                       timings=timings)
        wall = time.perf_counter() - t0
        launches = trace_segment.launches
        assert launches == n_seg == timings["segments"], (launches, n_seg)
        check_folds("16", "records", n_seg, device)
        rate = cfg.n_pix ** 2 * steps / timings["trace"]
        say(f"[16] step {i}: prepare_cubes(at_time({i})) {resample:.4f} s; "
            f"map wall {wall:.3f} s, trace {timings['trace']:.4f} s "
            f"({rate:.4g} ray-steps/s over {steps} steps), transfer "
            f"{timings['transfer']:.4f} s, finish {timings['finish']:.4f} s;"
            f" kernel and record-fold launches {launches} = segments {n_seg}")
        reset_counts()
        direct = run_ray_tracing_emission(model_path=path, timestep=i,
                                          config=cfg, verbose=False,
                                          device=device)
        assert trace_segment.launches == n_seg, trace_segment.launches
        check_folds("16", "records", n_seg, device)
        d_tb = float(np.max(np.abs(res["emission_cube"]
                                   - direct["emission_cube"])))
        d_vi = float(np.max(np.abs(res["emission_polVI_cube"]
                                   - direct["emission_polVI_cube"])))
        say(f"[16] step {i}: vs run_ray_tracing_emission(model_path=..., "
            f"timestep={i}): max |dT_b| {d_tb:.3g} K, max |dV/I| "
            f"{d_vi:.3g}")
        assert d_tb == 0.0 and d_vi == 0.0, (d_tb, d_vi)
        tb = np.load(npz)["emission_cube"]
        check_disk_tb("16", tb, disk)
        maps.append(tb)
        out.append({"resample": resample, "wall": wall, "timings": timings,
                    "rate": rate})
    rel = np.abs(maps[1][disk] - maps[0][disk]) / maps[0][disk]
    say(f"[16] step 1 vs step 0 over {rel.size} on-disk values: max rel "
        f"T_b difference {rel.max():.4g}, median {np.median(rel):.4g}")
    assert rel.max() > 1e-3, rel.max()
    map_kernel_vs_plain("16", cubes, DV_BAR_FIXED, device=device,
                        grid_n=cfg.grid_n)
    return out


def fold_scene(n_pix=256):
    """The canonical scene's first segment (n_pix^2 rays x 64 records; at
    256, 65,536 rays, phase 3; at 128, the sweep's 16,384) traced with a
    B-vector field, 10x the bundle scene's (|B| of order 10 G, so that
    gyroresonance layers at 75-89 MHz lie in the cube, and row 7 holds cos
    theta(B, k)). Returns the records and ray starts."""
    from raytracinggrff_tpu_torch.ops.trace_segment import trace_segment
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid, f, start, kdir = canonical_scene(n_pix)
    x, y, z = (torch.as_tensor(a.astype(np.float32), device=f["wpe"].device)
               for a in np.meshgrid(*grid.axes(), indexing="ij"))
    bvec = (10.0 * (1.0 + 0.2 * x), 10.0 * (0.5 * y - 0.3),
            10.0 * (0.2 - 0.4 * z))
    b = torch.sqrt(sum(c * c for c in bvec))
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], b, grid,
                                        bvec)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    _, recs = trace_segment(tcube, scube, state, grid, 6e-3, 1, 10, 64)
    return recs, start


def fold_flops(nf, mechanism, gaunt, s_max=30):
    """float32 operations of one valid voxel of the fold at nf
    frequencies, beyond those of its record (FOLD_FLOPS_*)."""
    terms = [FOLD_FLOPS_COMMON]
    if mechanism & 1:
        terms.append(FOLD_FLOPS_FF[gaunt])
        if mechanism & 4:
            terms.append(FOLD_FLOPS_NEUTRALS)
    if mechanism & 2:
        terms += [FOLD_FLOPS_GR] + [FOLD_FLOPS_HARMONIC] * max(0, s_max - 1)
    return sum(once + nf * per_freq for once, per_freq in terms)


def fold_records_bound(recs, prev, nf, mechanism, gaunt="dulk", s_on=True,
                       theta_los=False, s_max=30):
    """Least time for one record fold from the last valid positions
    `prev`. Operations: those of the records the fold takes (valid by
    los_scans.record_step, with finite fields and ds > 0; it skips the
    others), FOLD_FLOPS_RECORD and its S area and angle terms, and
    fold_flops. Bytes: of every record the rows that decide its validity
    (0-3, and 7 with theta_los), and rows 4-6 of the valid ones; the carry
    and the last valid positions read and written once. Returns (ms,
    "operations" or "bytes", the records taken)."""
    from raytracinggrff_tpu_torch.constants import R_SUN_CM
    from raytracinggrff_tpu_torch.ops.los_scans import record_step
    n_step = n_valid = 0
    for rec in recs:
        valid, ds, prev = record_step(
            rec[0:3].T, rec[3], prev, np.float32(R_SUN_CM),
            torch.isfinite(rec[7]) if theta_los else None)
        taken = (valid & torch.isfinite(rec[4:7]).all(dim=0)
                 & torch.isfinite(ds) & (ds > 0))
        n_step += int(valid.sum())
        n_valid += int(taken.sum())
    per_rec = FOLD_FLOPS_RECORD + int(s_on) + 3 * int(theta_los)
    ops = n_valid * (per_rec + fold_flops(nf, mechanism, gaunt, s_max))
    rps, n = recs.shape[0], recs.shape[2]
    nbytes = 4 * ((4 + int(theta_los)) * rps * n + 3 * n_step
                  + 2 * 4 * n * nf + 2 * 3 * n + nf)
    return (*bound(ops, nbytes), n_valid)


def fold_voxels_bound(ds, te, ne, b, valid, freqs, area, sarea=None,
                      theta=None, mech=None, theta_deg=90.0, mechanism=5,
                      s_max=30, gaunt="dulk", carry=None):
    """Least time for one voxel fold, called as fold_voxels. Operations:
    fold_flops of the voxels it takes (flagged valid, finite fields, ds >
    0), and sin and cos of a per-voxel theta. Bytes: the flags of all
    voxels, ds/te/ne/b of the flagged ones, sarea/theta/mech of the taken
    ones, the carry read (if given) and written once. Returns (ms,
    "operations" or "bytes", the voxels taken)."""
    taken = (valid & torch.isfinite(ne) & torch.isfinite(te)
             & torch.isfinite(b) & torch.isfinite(ds) & (ds > 0))
    n_flag, n_valid = int(valid.sum()), int(taken.sum())
    n, nf = ds.shape[1], freqs.shape[0]
    ops = n_valid * (fold_flops(nf, mechanism, gaunt, s_max)
                     + 2 * int(theta is not None))
    extra = sum(t is not None for t in (sarea, theta, mech))
    nbytes = (valid.numel() + 4 * (4 * n_flag + extra * n_valid + nf)
              + 4 * 4 * n * nf * (1 + int(carry is not None)))
    return (*bound(ops, nbytes), n_valid)


def fold_agreement(out, ref):
    """Kernel carry `out` against plain `ref`: the max relative flux
    difference over entries above 1e-30, the max absolute flux difference,
    the (ray, frequency) entries whose evanescent state (tau = inf) is
    the same in both modes, as (count, total), and whether the four
    carries are equal (torch.equal)."""
    rel = absd = 0.0
    for a, b in zip(out[:2], ref[:2]):
        sel = torch.isfinite(b) & (b.abs() > 1e-30)
        d = (a - b).abs()
        rel = max(rel, float((d[sel] / b[sel].abs()).max()))
        absd = max(absd, float(d[torch.isfinite(d)].max()))
    same = ((torch.isinf(out[2]) == torch.isinf(ref[2]))
            & (torch.isinf(out[3]) == torch.isinf(ref[3])))
    equal = all(torch.equal(a, b) for a, b in zip(out, ref))
    return rel, absd, (int(same.sum()), same.numel()), equal


def hold_fold(tag, what, out, ref, mechanism, times, bound, phase="17"):
    """Print and hold one fold against its plain version: every evanescent
    set equal, and the carries equal (torch.equal) without gyroresonance
    (mechanism bit 2), or flux max rel 1e-4 with it. times: (kernel ms by
    cuda_ms, by device_ms, plain ms); bound: (ms, "bytes" or "operations",
    voxels taken). Returns (max rel, max |diff|)."""
    rel, absd, (same, total), equal = fold_agreement(out, ref)
    ms, dev_ms, plain_ms = times
    bound_ms, bound_by, n_valid = bound
    say(f"[{phase}] {what} ({n_valid} valid): kernel vs plain, carries equal "
        f"{equal}, flux max rel {rel:.3g}, max |diff| {absd:.3g} SFU; "
        f"evanescent sets equal on {same} of {total} entries; kernel "
        f"{ms:.4f} ms ({dev_ms:.4f} ms on the device alone), plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.4f} of it ({bound_ms / dev_ms:.4f} of the "
        f"device time)")
    assert same == total, (tag, same, total)
    assert equal if not mechanism & 2 else rel <= 1e-4, (tag, rel, equal)
    return rel, absd


def time_fold(fold, plain, reps=20):
    """(kernel result, plain result, (kernel ms by cuda_ms, by device_ms,
    plain ms)) of the calls fold() and plain()."""
    res, ref = fold(), plain()
    times = (cuda_ms(fold, reps=reps), device_ms(fold, reps=reps),
             cuda_ms(plain, reps=1))
    return res, ref, times


@contextlib.contextmanager
def captured_voxel_folds():
    """Record the arguments of each fold_voxels call while the block runs;
    the calls run and count as usual."""
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    fold = tf.fold_voxels
    seen = []

    def spy(*args, **kw):
        seen.append((args, kw))
        return fold(*args, **kw)

    tf.fold_voxels = spy
    try:
        yield seen
    finally:
        tf.fold_voxels = fold


# phase 17's fold on the main path's settings: its kernels-line entry
MAIN_FOLD = "(a) record fold, mechanism 5, fixed theta"


def fold_cases(n_pix=256, sweep_pix=128):
    """Phase 17's record folds alone, {name: ("records", args, kw)} with
    args fold_records' (recs, carry, prev, freqs, area): (a) on
    fold_scene(n_pix) at nfreq 3 with S input (the main path's settings),
    mechanisms 1, 5 and 7, fixed theta and theta_mode 'los'; mechanism 5
    at fixed theta with Nf 1, 5 and 9; mechanism 7 at s_max 200 with
    theta_mode 'los'; (a') at the sweep's size, fold_scene(sweep_pix) at
    Nf 1, mechanism 5, fixed theta."""
    from raytracinggrff_tpu_torch.constants import R_SUN_CM
    from raytracinggrff_tpu_torch.grff.transfer import (log_spaced_freqs,
                                                        transfer_carry_init)
    cases = {}
    for tag, pix in (("(a)", n_pix), ("(a')", sweep_pix)):
        recs, start = fold_scene(pix)
        n = recs.shape[2]
        area = ((2 * 1.44) / round(n ** 0.5) * R_SUN_CM) ** 2
        prev = torch.as_tensor(start, device=recs.device)

        def case(nf, **kw):
            freqs = torch.as_tensor(log_spaced_freqs(75e6, nf, 0.05),
                                    dtype=torch.float32, device=recs.device)
            args = (recs, transfer_carry_init(n, nf, recs.device), prev,
                    freqs, area)
            return "records", args, dict(theta_deg=90.0, s_on=True, **kw)

        if tag == "(a')":
            cases["(a') record fold at the sweep's size, mechanism 5, fixed "
                  "theta"] = case(1, mechanism=5, theta_los=False)
            continue
        for mechanism in (1, 5, 7):
            for theta_los in (False, True):
                what = "theta_mode 'los'" if theta_los else "fixed theta"
                cases[f"(a) record fold, mechanism {mechanism}, {what}"] = \
                    case(3, mechanism=mechanism, theta_los=theta_los)
        for nf in (1, 5, 9):
            cases[f"(a) record fold, mechanism 5, fixed theta, Nf {nf}"] = \
                case(nf, mechanism=5, theta_los=False)
        cases["(a) record fold, mechanism 7 at s_max 200, theta_mode "
              "'los'"] = case(3, mechanism=7, s_max=200, theta_los=True)
    return cases


def los_chain_fold(los, device="cuda"):
    """The LOS chain's synthetic_ff on LOS data `los` (450 MHz, 4
    frequencies): its result and the (args, kw) of its one fold_voxels
    call."""
    from raytracinggrff_tpu_torch.pipeline import synthetic_ff
    with captured_voxel_folds() as seen:
        em = synthetic_ff(los, 450e6, 4, 0.1, verbose=False, device=device)
    return em, seen[0]


def phase_fold(out, tmp, los6, device="cuda", n_pix=256, n_steps=5000,
               grid_n=128, sweep_pix=128):
    """Phase 17: the transfer folds against their plain versions. (a) and
    (a'): the record folds of fold_cases alone; (b) the production map and
    phase 7's gyroresonance map with their transfer through the kernel and
    through the plain fold; (c) the LOS chain's synthetic_ff on phase 6's
    LOS data `los6` through the voxel fold and the plain one, and that fold
    alone. Every fold alone is held by hold_fold. Fills out["fold"]
    (MAIN_FOLD) and out["voxel_fold"] for the kernels line. The maps are
    SLICE's with `n_pix`, `n_steps` and `grid_n`."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission,
                                                   synthetic_ff)

    def fold_case(name, args, kw):
        recs, freqs = args[0], args[3]
        nf, n, mech = freqs.shape[0], recs.shape[2], kw["mechanism"]
        res, ref, times = time_fold(
            lambda: tf.fold_records(*args, **kw)[0],
            lambda: tf.fold_records_plain(*args, **kw)[0])
        bound = fold_records_bound(recs, args[2], nf, mech, s_on=True,
                                   theta_los=kw["theta_los"],
                                   s_max=kw.get("s_max", 30))
        _, absd = hold_fold(name, f"{name} ({n} rays x {recs.shape[0]} "
                            f"records x {nf} frequencies, group "
                            f"{tf.group_size(nf, n)})", res, ref, mech,
                            times, bound)
        return dict(ms=times[0], plain_ms=times[2], bound_ms=bound[0],
                    bound_by=bound[1], max_abs_err=absd)

    cases = fold_cases(sweep_pix=sweep_pix)
    for name, (_, args, kw) in cases.items():
        case = fold_case(name, args, kw)
        if name == MAIN_FOLD:
            out["fold"] = case
    del cases

    model = synthetic_mas_model(Path(tmp) / "corona_fold", timestep=2)
    grid = UniformGrid.cube(3.0, grid_n)
    reset_counts()
    cubes = prepare_cubes(MASModel(model), grid, 0.0, verbose=False,
                          device=device)
    gr_model = synthetic_mas_model(Path(tmp) / "corona_fold_gr",
                                   b0_gauss=50.0)
    gr_cubes = prepare_cubes(MASModel(gr_model), grid, 0.0, verbose=False,
                             keep_bvec=True, device=device)
    check_kernel("17", "resample", "cube", 2, device)
    sizes = dict(SLICE, n_pix=n_pix, n_steps=n_steps, grid_n=grid_n)
    cfg = RayEmissionConfig(**sizes)
    cfg_gr = RayEmissionConfig(**dict(sizes, mechanism=7, theta_mode="los"))
    for name, c, cb, bar in (("production map", cfg, cubes, DV_BAR_FIXED),
                             ("gyroresonance map", cfg_gr, gr_cubes,
                              DV_BAR_GR)):
        t_k, t_p = {}, {}
        reset_counts()
        r_k = run_ray_tracing_emission(cubes=cb, config=c, verbose=False,
                                       device=device, timings=t_k)
        folds = check_folds("17", "records", n_segments(c), device)
        with plain_folds():
            r_p = run_ray_tracing_emission(cubes=cb, config=c,
                                           verbose=False, device=device,
                                           timings=t_p)
        hold_maps("17", f"(b) {name} {n_pix}^2 x {n_steps} x {grid_n}^3, "
                  f"transfer "
                  f"through the kernel ({folds} launches, "
                  f"{t_k['transfer']:.4f} s) vs the plain fold "
                  f"({t_p['transfer']:.4f} s)", r_p, r_k, bar,
                  disk_mask(n_pix, 1.44))
    del cubes, gr_cubes

    reset_counts()
    em_k, (args, kw) = los_chain_fold(los6["los"], device)
    check_folds("17", "voxels", 1, device)
    with plain_folds():
        em_p, _ = los_chain_fold(los6["los"], device)
    for key in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(em_k[key], los6["map"][key])
    n_pix = em_k["emission_cube"].shape[0]
    hold_maps("17", f"(c) LOS chain synthetic_ff {n_pix}^2, voxel fold vs "
              f"the plain fold", em_p, em_k, DV_BAR_FIXED,
              disk_mask(n_pix, 1.44))
    res, ref, times = time_fold(lambda: tf.fold_voxels(*args, **kw),
                                lambda: tf.fold_voxels_plain(*args, **kw))
    bound = fold_voxels_bound(*args, **kw)
    ds, nf, mechanism = args[0], args[5].shape[0], args[11]
    _, absd = hold_fold("(c)", f"(c) voxel fold alone ({ds.shape[0]} voxels "
                        f"x {ds.shape[1]} pixels x {nf} frequencies, "
                        f"mechanism {mechanism})", res, ref, mechanism,
                        times, bound)
    out["voxel_fold"] = dict(launches=los6["fold_launches"], ms=times[0],
                             plain_ms=times[2], bound_ms=bound[0],
                             bound_by=bound[1], max_abs_err=absd)


def phase_counts(tmp, device="cuda", n_pix=256, sweep_pix=128,
                 n_steps=5000, grid_n=128):
    """Phase 19: the record fold's counts against fold_counts_plain, alone
    on fold_scene(n_pix) and fold_scene(sweep_pix) with and without
    theta_mode 'los', then in phase 7's gyroresonance map (SLICE's with
    `n_pix`, `n_steps` and `grid_n`, mechanism 7, theta_mode 'los', 11
    frequencies at log step 0.01) under torch.profiler."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    for pix in (n_pix, sweep_pix):
        recs, start = fold_scene(pix)
        prev = torch.as_tensor(start, device=recs.device)
        n = recs.shape[2]
        for theta_los in (False, True):
            counts = torch.zeros(2, dtype=torch.int64, device=recs.device)
            reset_counts()
            tf.fold_counts(recs, prev, counts, theta_los)
            check_kernel("19", "transfer_fold", "counts", 1, device)
            want = tf.fold_counts_plain(recs, prev, theta_los)
            taken = fold_records_bound(recs, prev, 1, 7,
                                       theta_los=theta_los)[2]
            got = counts.tolist()
            assert torch.equal(counts, want), (pix, theta_los, got, want)
            assert got[1] == taken and 0 < got[1] <= got[0], (got, taken)

            def count():
                tf.fold_counts(recs, prev, counts, theta_los)

            what = "theta_mode 'los'" if theta_los else "fixed theta"
            say(f"[19] fold counts, {n} rays x {recs.shape[0]} records, "
                f"{what}: [stepped from, taken] {got}, equal to the plain "
                f"count's, fold_records_bound takes {taken}; "
                f"{cuda_ms(count, reps=20):.4f} ms "
                f"({device_ms(count):.4f} ms on the device alone)")
        del recs

    model = synthetic_mas_model(Path(tmp) / "corona_counts", b0_gauss=50.0)
    grid = UniformGrid.cube(3.0, grid_n)
    cubes = prepare_cubes(MASModel(model), grid, 0.0, verbose=False,
                          keep_bvec=True, device=device)
    cfg = RayEmissionConfig(**dict(SLICE, n_pix=n_pix, n_steps=n_steps,
                                   grid_n=grid_n, nfreq=11,
                                   freq_log_step=0.01, mechanism=7,
                                   theta_mode="los"))
    untraced = run_ray_tracing_emission(cubes=cubes, config=cfg,
                                        verbose=False, device=device)
    seen, fold = [], tf.fold_records

    def spy(recs, carry, prev, *args, **kw):
        seen.append((recs.clone(), prev.clone()))
        return fold(recs, carry, prev, *args, **kw)

    timings = {}
    tf.fold_records = spy
    reset_counts()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]):
            traced = run_ray_tracing_emission(cubes=cubes, config=cfg,
                                              verbose=False, device=device,
                                              timings=timings)
    finally:
        tf.fold_records = fold
    n_seg = n_segments(cfg)
    check_kernel("19", "transfer_fold", "counts", n_seg, device)
    counts = timings["fold_counts"]
    assert len(counts) == len(seen) == n_seg, (len(counts), len(seen))
    for (recs, prev), got in zip(seen, counts):
        want = tf.fold_counts_plain(recs, prev, True).tolist()
        assert got == want, (got, want)
    for key in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(traced[key], untraced[key])
    say(f"[19] gyroresonance map {n_pix}^2 x {n_steps} x {grid_n}^3 at 11 "
        f"frequencies under torch.profiler: {n_seg} count launches, "
        f"[stepped from, taken] a segment {counts} equal to the plain "
        f"count's, span 'count' {1e3 * timings['count']:.4f} ms against "
        f"'transfer' {1e3 * timings['transfer']:.4f} ms; the map equals "
        f"the untraced one")


@contextlib.contextmanager
def plain_scenes():
    """Route the resample, the spherical sampler, the ds scan and the DEM
    scan through their plain versions on CUDA tensors for a comparison
    run; the wrappers themselves never do."""
    from raytracinggrff_tpu_torch import sampler
    from raytracinggrff_tpu_torch.grff import transfer
    from raytracinggrff_tpu_torch.ops import los_scans, resample
    saved = (resample.resample_cubes, resample.sample_sph_many,
             sampler.valid_ds, transfer.dem_scan)
    resample.resample_cubes = resample.resample_cubes_plain
    resample.sample_sph_many = resample.sample_sph_many_plain
    sampler.valid_ds = los_scans.valid_ds_plain
    transfer.dem_scan = los_scans.dem_scan_plain
    try:
        yield
    finally:
        (resample.resample_cubes, resample.sample_sph_many, sampler.valid_ds,
         transfer.dem_scan) = saved


@contextlib.contextmanager
def captured(module, name):
    """Record the (args, kw) of each call of module.`name` while the block
    runs; the calls run and count as usual."""
    fn = getattr(module, name)
    seen = []

    def spy(*args, **kw):
        seen.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, spy)
    try:
        yield seen
    finally:
        setattr(module, name, fn)


def ulp_order(x):
    """float32 tensor -> int64 keys in the order of the values, one apart
    for neighbouring floats (-0 and +0 equal)."""
    i = x.contiguous().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def float_agreement(a, b):
    """float32 tensors a (kernel) and b (plain): whether their NaN masks
    are equal, the count of entries, NaN in neither, that differ, the
    largest of those differences in ulps and in absolute value."""
    na, nb = torch.isnan(a), torch.isnan(b)
    both = ~(na | nb)
    x, y = a[both], b[both]
    part = x != y
    n = int(part.sum())
    ulps = int((ulp_order(x[part]) - ulp_order(y[part])).abs().max()) \
        if n else 0
    absd = float((x[part].double() - y[part].double()).abs().max()) \
        if n else 0.0
    return torch.equal(na, nb), n, ulps, absd


def hold_floats(tag, what, a, b, ulp_bar=0):
    """Print and hold kernel result `a` against plain `b`: equal NaN masks,
    and every other entry equal, or within ulp_bar ulps. Returns the
    largest absolute difference."""
    same_nan, n, ulps, absd = float_agreement(a, b)
    say(f"[{tag}] {what}: NaN masks equal {same_nan} "
        f"({int(torch.isnan(b).sum())} NaN of {b.numel()}), {n} other "
        f"entries differ, by at most "
        f"{ulps} ulp ({absd:.3g}); bar {ulp_bar} ulp")
    assert same_nan and ulps <= ulp_bar, (tag, what, n, ulps)
    return absd


def sweep_cube_sets():
    """The TbSpectra sweep's distinct (grid_n, grid_extent) cube sets at
    its CLI defaults (lattice presets), in frequency order."""
    from raytracinggrff_tpu_torch.cli.tb_spectra import (quantize_params,
                                                         select_params,
                                                         sweep_frequencies)
    sets = []
    for f in sweep_frequencies():
        p = quantize_params(select_params(float(f)))
        key = (int(p["grid_n"]), round(float(p["grid_extent"]), 6))
        if key not in sets:
            sets.append(key)
    return sets


# phase 18 (a): the production map's cube set, and the sweep's largest
# (its index 29, 800 MHz): (grid_n, grid_extent, phi0)
RESAMPLE_SETS = ((128, 3.0, 0.0), (576, 1.5, -140.0))
MAS_VARIABLES = ("rho", "t", "br", "bt", "bp")
# device ms of one variable's resample at RESAMPLE_SETS' sizes and of one
# variable's sample at phase 6's 6,553,600 points in the one-variable-a-
# launch design that came before the scene launch (a thread a voxel, axes
# searched in global memory; NVIDIA H100 80GB HBM3 at 700 W, PERF.md)
ONE_VARIABLE_DESIGN_MS = {128: 0.0419, 576: 3.4342, "sample": 0.0998}


def pack_scene(n, extent):
    """The (grid, [omega_pe, ne, te, b, Bx, By, Bz]) of a trace-input
    launch on an n^3 cube of half-width `extent`, float32 on the card:
    harness.make_cube's density profile, and bundle_scene's te, b and B
    vector, computed on the device."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    grid = UniformGrid.cube(extent, n)
    x, y, z = torch.meshgrid(*[torch.as_tensor(a, dtype=torch.float32,
                                               device="cuda")
                               for a in grid.axes()], indexing="ij")
    r = torch.sqrt(x * x + y * y + z * z)
    ne = 4.2e4 * 10 ** (4.32 / torch.clamp(r, min=0.5))
    return grid, [8.93e3 * torch.sqrt(ne) * 2 * np.pi, ne,
                  1e6 + 1e5 * z, 1.0 + 0.2 * x, 1.0 + 0.2 * x,
                  0.5 * y - 0.3, 0.2 - 0.4 * z]


def phase_pack(out, sets=((128, 3.0), (576, 1.5))):
    """Phase 20: rgrff_pack_trace_inputs against pack_trace_inputs_plain
    on pack_scene at each (n, extent) of `sets` (the canonical cube and
    the sweep's largest), with 4 and 8 sample channels: both cubes equal
    bit for bit (int32 views), one launch a call, the wrapper timed by
    cuda_ms, the kernel alone by device_ms, the plain version by cuda_ms,
    beside the bound of PACK_BYTES a voxel at PEAK_BYTES_S. Keeps the
    largest set's 4-channel entry in out["pack"]."""
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        pack_trace_inputs, pack_trace_inputs_plain)
    for n, extent in sets:
        grid, f = pack_scene(n, extent)
        for channels in (4, 8):
            args = (*f[:4], grid, tuple(f[4:]) if channels == 8 else None)
            reset_counts()
            got = pack_trace_inputs(*args)
            assert pack_trace_inputs.launches == 1, pack_trace_inputs.launches
            want = pack_trace_inputs_plain(*args)
            equal = [torch.equal(a.view(torch.int32), b.view(torch.int32))
                     for a, b in zip(got, want)]
            say(f"[20] {n}^3, {channels} channels: trace and sample cubes "
                f"equal to the plain version's bit for bit {equal}")
            assert all(equal), equal
            del got, want
            times = time_kernel(lambda: pack_trace_inputs(*args),
                                lambda: pack_trace_inputs_plain(*args))
            entry = kernel_entry(
                "20", f"pack_trace_inputs at {n}^3, {channels} channels",
                times, bound(0, PACK_BYTES[channels] * n ** 3), 0.0)
            if channels == 4:
                out["pack"] = entry
        del f
        torch.cuda.empty_cache()


def resample_bound(arrays, n):
    """Least time for one cube resample of n^3 voxels from the MAS arrays
    (data and axes): RESAMPLE_FLOPS a voxel, the cube written and the
    arrays and its three axes read once."""
    nbytes = 4 * (n ** 3 + sum(a.numel() for a in arrays) + 3 * n)
    return bound(RESAMPLE_FLOPS * n ** 3, nbytes)


def sample_bound(variables, n):
    """Least time for one launch that samples `variables`, (data, phi,
    theta, r) tuples, at n points: SAMPLE_FLOPS a variable and point, the
    three queries read once, one sample written a variable and point, and
    each distinct array and axis read once."""
    arrays = {a.data_ptr(): a.numel() for v in variables for a in v}
    nbytes = 4 * (3 * n + len(variables) * n + sum(arrays.values()))
    return bound(SAMPLE_FLOPS * n * len(variables), nbytes)


def scene_bound(bounds):
    """The bound of a scene's launch: the sum of its variables' (ms,
    kind), the kind of the largest."""
    return (sum(ms for ms, _ in bounds), max(bounds)[1])


def time_kernel(kernel, plain, reps=20):
    """(kernel ms by cuda_ms, kernel ms by device_ms, plain ms by cuda_ms
    over one call) of the calls kernel() and plain()."""
    return (cuda_ms(kernel, reps=reps), device_ms(kernel, reps=reps),
            cuda_ms(plain, reps=1))


def kernel_entry(tag, what, times, bnd, absd):
    """Print one kernel's times beside its bound; its kernels-line entry
    (ms by device_ms)."""
    ms, dev_ms, plain_ms = times
    bound_ms, bound_by = bnd
    say(f"[{tag}] {what}: kernel {ms:.4f} ms ({dev_ms:.4f} ms on the device "
        f"alone), plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {bound_ms / dev_ms:.4f} of the device time")
    return dict(ms=dev_ms, wrapper_ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=absd)


def staggered_scene(model, device="cuda"):
    """The synthetic model's five variables on a staggered mesh, as a MAS
    run staggers them: rho and t on the model's mesh, br on its r
    half-steps, bt on its theta half-steps, bp on its phi half-steps (each
    array cut to its mesh's shape)."""
    from raytracinggrff_tpu_torch.mas.model import scene_arrays

    def half(a):
        return 0.5 * (a[:-1] + a[1:])

    variables = [model[v] for v in MAS_VARIABLES]
    scene = scene_arrays(variables, device)
    (data_r, phi, theta, r), (data_t, *_), (data_p, *_) = (
        scene[2], scene[3], scene[4])
    phi_h = half(phi)
    phi_h = torch.cat([phi_h, phi_h[:1] + np.float32(2 * np.pi)])
    scene[2] = (data_r[:, :, :-1].contiguous(), phi, theta, half(r))
    scene[3] = (data_t[:, :-1].contiguous(), phi, half(theta), r)
    scene[4] = (data_p, phi_h, theta, r)
    return scene


def phase_resample(out, tmp, device="cuda", sets=RESAMPLE_SETS,
                   names=MAS_VARIABLES, map_pix=256, map_steps=5000):
    """Phase 18 (a): rgrff_resample_cube against resample_cube_plain: the
    synthetic model's variables `names` in one launch at each (grid_n,
    extent, phi0) of `sets`, and a staggered scene of its five variables
    (staggered_scene) at the first set, each with fill_nan None and 0.0,
    every variable's cube held to its plain cube (hold_floats,
    RESAMPLE_ULP_BAR); the scene's launch timed at each size beside the
    first variable's launch alone (the kernels line takes the first set's
    scene: the production map's); then prepare_cubes (one launch) and the
    production map (SLICE at map_pix^2 x map_steps) from its cubes against
    the map from the plain cubes, under the map bars."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import (MASModel, scene_arrays,
                                                    synthetic_mas_model)
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                                   prepare_cubes,
                                                   run_ray_tracing_emission)
    model = MASModel(synthetic_mas_model(Path(tmp) / "corona_rs"))
    scene = scene_arrays([model[v] for v in names], device)
    worst, entry = 0.0, None
    cases = [(f"{len(names)} variables", scene, *sets[0])]
    if len(names) == len(MAS_VARIABLES):
        cases.append(("staggered scene", staggered_scene(model, device),
                      *sets[0]))
    cases += [(f"{len(names)} variables", scene, *s) for s in sets[1:]]
    for what, variables, n, extent, phi0 in cases:
        grid = UniformGrid.cube(extent, n)
        axes = [torch.as_tensor(a, dtype=torch.float32, device=device)
                for a in grid.axes()]
        for fill in (None, 0.0):
            reset_counts()
            k = resample.resample_cubes(variables, *axes, phi0, fill)
            check_kernel("18", "resample", "cube", 1, device)
            for v, (name, cube) in enumerate(zip(names, k)):
                p = resample.resample_cube_plain(*variables[v], *axes, phi0,
                                                 fill)
                worst = max(worst, hold_floats(
                    "18", f"(a) {what}, {name} on {n}^3 at extent {extent}, "
                    f"phi0 {phi0}, fill {fill}", cube, p, RESAMPLE_ULP_BAR))
                del p
            del k
        if what == "staggered scene":
            continue
        times = time_kernel(
            lambda: resample.resample_cubes(variables, *axes, phi0, None),
            lambda: resample.resample_cubes_plain(variables, *axes, phi0,
                                                  None), reps=5)
        bnd = scene_bound([resample_bound(a, n) for a in variables])
        timed = kernel_entry("18", f"(a) one launch of {len(names)} "
                             f"variables onto {n}^3", times, bnd, worst)
        entry = entry or timed     # the production map's set
        one = device_ms(lambda: resample.resample_cube(*variables[0], *axes,
                                                       phi0, None), reps=5)
        one_bnd = resample_bound(variables[0], n)[0]
        say(f"[18] (a) one variable ({names[0]}) onto {n}^3 alone: "
            f"{one:.4f} ms on the device (the one-variable design: "
            f"{ONE_VARIABLE_DESIGN_MS.get(n, float('nan')):.4f} ms), bound "
            f"{one_bnd:.4f} ms, {one_bnd / one:.4f} of it; the scene's "
            f"launch {timed['ms'] / one:.3f} x one variable's")
    entry["max_abs_err"] = worst
    out["resample_cube"] = entry

    grid = UniformGrid.cube(3.0, 128)
    reset_counts()
    cubes_k = prepare_cubes(model, grid, 0.0, verbose=False, device=device)
    check_kernel("18", "resample", "cube", 1, device)
    with plain_scenes():
        cubes_p = prepare_cubes(model, grid, 0.0, verbose=False,
                                device=device)
    for key in ("omega_pe", "ne", "te", "b"):
        hold_floats("18", f"(a) prepare_cubes {key}, kernel vs plain",
                    cubes_k[key], cubes_p[key], RESAMPLE_ULP_BAR)
    cfg = RayEmissionConfig(**dict(SLICE, n_pix=map_pix, n_steps=map_steps))
    r_k = run_ray_tracing_emission(cubes=cubes_k, config=cfg, verbose=False,
                                   device=device)
    r_p = run_ray_tracing_emission(cubes=cubes_p, config=cfg, verbose=False,
                                   device=device)
    hold_maps("18", f"(a) production map {map_pix}^2 x {map_steps} from "
              f"kernel cubes vs plain cubes", r_p, r_k, DV_BAR_FIXED,
              disk_mask(map_pix, cfg.x_fov))


def phase_sample(out, tmp, device="cuda", n_pix=128):
    """Phase 18 (b): resample_mas_los at the CLI defaults (phase 6's
    shapes) with its five variables sampled in one launch of
    rgrff_sample_sph and through sample_sph_plain: Ne, Te and B equal
    (hold_floats); then that launch alone, timed both ways, and the first
    variable's launch alone."""
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.pipeline import resample_mas_los
    model = synthetic_mas_model(Path(tmp) / "corona_sph")
    kw = dict(n_pix=n_pix, x_range=(-1.44, 1.44), y_range=(-1.44, 1.44),
              n_z=400, dz0=3e-4, phi0_offset=24.0, verbose=False,
              device=device)
    reset_counts()
    with captured(resample, "sample_sph_many") as calls:
        t0 = time.perf_counter()
        los_k = resample_mas_los(model, **kw)
        t_k = time.perf_counter() - t0
    check_kernel("18", "resample", "sph", 1, device)
    with plain_scenes():
        t0 = time.perf_counter()
        los_p = resample_mas_los(model, **kw)
        t_p = time.perf_counter() - t0
    say(f"[18] (b) resample_mas_los {n_pix}^2 x 400: {t_k:.3f} s through "
        f"the kernel, {t_p:.3f} s through the plain sampler")
    worst = 0.0
    for key in ("Ne_LOS", "Te_LOS", "B_LOS"):
        worst = max(worst, hold_floats(
            "18", f"(b) {key} (float64 of the float32 samples)",
            torch.as_tensor(los_k[key]).float(),
            torch.as_tensor(los_p[key]).float(), RESAMPLE_ULP_BAR))
    (variables, *queries), _ = calls[0]
    n = queries[0].numel()
    times = time_kernel(lambda: resample.sample_sph_many(variables, *queries),
                        lambda: resample.sample_sph_many_plain(variables,
                                                               *queries))
    bnd = sample_bound(variables, n)
    entry = kernel_entry("18", f"(b) one launch of {len(variables)} "
                         f"variables at {n} points", times, bnd, worst)
    one = device_ms(lambda: resample.sample_sph(*variables[0], *queries))
    say(f"[18] (b) one variable at {n} points alone: {one:.4f} ms on the "
        f"device (the one-variable design: "
        f"{ONE_VARIABLE_DESIGN_MS['sample']:.4f} ms); the scene's launch "
        f"{entry['ms'] / one:.3f} x one variable's")
    out["sample_sph"] = entry


def phase_scans(out, device="cuda", n_pix=256):
    """Phase 18 (c): rgrff_valid_ds against valid_ds_plain on the canonical
    scene's first segment (fold_scene: n_pix^2 rays x 64 records), with and
    without a `usable` mask (row 7 finite), valid and ds equal
    (torch.equal), timed; and pipeline._center_los of the inspection
    pixel, with and without cos theta, through the kernel and the plain
    scan. (d) get_mw in DEM mode (dem_case) through rgrff_dem_scan and
    dem_scan_plain, free-free and with gyroresonance, RL equal, and the
    scan alone timed."""
    from raytracinggrff_tpu_torch.grff import transfer
    from raytracinggrff_tpu_torch.ops import los_scans
    from raytracinggrff_tpu_torch.pipeline import _center_los
    from raytracinggrff_tpu_torch.utils.plotting import inspection_pixel_index
    recs, start = fold_scene(n_pix)
    pos = recs[:, 0:3].transpose(1, 2).contiguous()
    s = recs[:, 3].contiguous()
    prev = torch.as_tensor(start, device=recs.device)
    n_rec, n = s.shape
    row7 = torch.isfinite(recs[:, 7])
    for usable in (None, row7):
        res = los_scans.valid_ds(pos, s, prev, usable=usable)
        ref = los_scans.valid_ds_plain(pos, s, prev, usable=usable)
        equal = [torch.equal(a, b) for a, b in zip(res, ref)]
        say(f"[18] (c) valid_ds, {n} rays x {n_rec} records, usable "
            f"{usable is not None}: {int(ref[0].sum())} valid; valid and ds "
            f"equal (torch.equal) {equal}")
        assert all(equal), equal
    n_valid = int(res[0].sum())
    nbytes = n_rec * n * (12 + 4 + 1 + 1 + 4) + 12 * n
    times = time_kernel(
        lambda: los_scans.valid_ds(pos, s, prev, usable=row7),
        lambda: los_scans.valid_ds_plain(pos, s, prev, usable=row7))
    out["valid_ds"] = kernel_entry(
        "18", f"(c) valid_ds alone ({n} rays x {n_rec} records, usable)",
        times, bound(DS_FLOPS * n_valid, nbytes), 0.0)
    p = inspection_pixel_index(n_pix)
    rows = recs[:, :, p].contiguous()
    for with_cos in (False, True):
        reset_counts()
        got = _center_los(rows, start[p], with_cos)
        check_kernel("18", "los_scans", "valid_ds", 1, device)
        with plain_scenes():
            want = _center_los(rows, start[p], with_cos)
        equal = (torch.equal(got.valid_mask, want.valid_mask)
                 and torch.equal(got.ds, want.ds))
        say(f"[18] (c) _center_los of pixel {p}, cos theta {with_cos}: "
            f"{int(want.valid_mask.sum())} valid of {rows.shape[0]}; valid "
            f"and ds equal {equal}")
        assert equal
    del recs, pos, s

    for mech in (1, 3):
        args = dem_case(mech=mech)
        reset_counts()
        with captured(transfer, "dem_scan") as calls:
            rl_k = transfer.get_mw(*args, device=device)
        out["dem_launches"] = check_kernel("18", "los_scans", "dem", 1,
                                           device)
        with plain_scenes():
            rl_p = transfer.get_mw(*args, device=device)
        equal = bool(np.array_equal(rl_k, rl_p))
        lp = args[0]
        say(f"[18] (d) get_mw DEM mode, Nz {lp[0]}, Nf {lp[1]}, NT {lp[2]}, "
            f"mechanism {mech}: RL equal {equal}; flux O {rl_k[5].min():.4g}"
            f"..{rl_k[5].max():.4g} SFU, tau O up to {rl_k[1].max():.4g}")
        assert equal and np.all(np.isfinite(rl_k[5])), mech
    (tau, src, evan, m), _ = calls[0]
    nz, nf = tau.shape[1:]
    times = time_kernel(lambda: los_scans.dem_scan(tau, src, evan, m),
                        lambda: los_scans.dem_scan_plain(tau, src, evan, m))
    nbytes = 2 * nz * nf * 9 + nz + 16 * nf
    out["dem_scan"] = kernel_entry(
        "18", f"(d) dem_scan alone (2 modes x {nz} voxels x {nf} "
        f"frequencies)", times, bound(DEM_FLOPS * 2 * nz * nf, nbytes), 0.0)


def phase_highband(out, tmp, freq=800e6, n_pix=128, x_fov=1.44,
                   device="cuda"):
    """Phase 21: compare_frequency at HIGHBAND_PRESETS[freq] (the CLI's
    --highband, the benchmark's compare_800mhz unit) from a synthetic MAS
    model, with the launch counts set to 0 just before it and checked
    just after: trace and record-fold launches = segments, one trace-input
    launch, one resample, one sampler launch, one voxel fold; both maps
    finite, both .npz written. Then each kernel of the run is held to its plain version on
    the device inputs the run gave it, and timed beside its bound: the
    resample's five cubes (hold_floats, RESAMPLE_ULP_BAR), the trace's
    first segment (hold_segment, >= 99% of rays), the sampler's five
    variables (hold_floats) and the voxel fold (hold_fold). Fills
    out["highband"] with the kernels' entries."""
    from raytracinggrff_tpu_torch.cli.compare_los_raytracing import (
        HIGHBAND_PRESETS, compare_frequency)
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    from raytracinggrff_tpu_torch.ops.trace_segment import (
        pack_trace_inputs, trace_segment, trace_segment_plain)
    from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig
    p = HIGHBAND_PRESETS[freq]
    n = p["grid_n"]
    cfg = RayEmissionConfig(n_steps=p["n_steps"],
                            record_stride=p["record_stride"])
    model = synthetic_mas_model(Path(tmp) / "corona_hb")
    timings = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with captured(resample, "resample_cubes") as scenes, \
            captured(resample, "sample_sph_many") as samples, \
            captured_voxel_folds() as folds, \
            first_segments(keep_cubes=True) as firsts:
        t0 = time.perf_counter()
        ray, los = compare_frequency(model, freq, n_pix=n_pix, x_fov=x_fov,
                                     phi0_offset=0.0, highband=True,
                                     ray_npz=Path(tmp) / "ray.npz",
                                     los_npz=Path(tmp) / "los.npz",
                                     verbose=False, device=device,
                                     timings=timings)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = trace_segment.launches
    assert launches == n_segments(cfg) == timings["segments"], launches
    assert pack_trace_inputs.launches == 1, pack_trace_inputs.launches
    check_folds("21", "records", launches, device)
    check_folds("21", "voxels", 1, device)
    check_kernel("21", "resample", "cube", 1, device)
    check_kernel("21", "resample", "sph", 1, device)
    for res in (ray, los):
        for key in ("emission_cube", "emission_polVI_cube"):
            assert np.all(np.isfinite(res[key])), key
    disk = disk_mask(n_pix, x_fov)
    a, b = ray["emission_cube"][:, :, 0], los["emission_cube"][:, :, 0]
    say(f"[21] {freq / 1e6:.0f} MHz preset ({n_pix}^2 rays x "
        f"{p['n_steps']} steps, stride {p['record_stride']}, dt {p['dt']}, "
        f"{n}^3 cube; LOS {n_pix}^2 x {p['n_z']}): {wall:.3f} s for both "
        f"maps; ray {timings['ray']:.4f} s (resample "
        f"{timings['resample']:.4f}, trace {timings['trace']:.4f}, transfer "
        f"{timings['transfer']:.4f}, finish {timings['finish']:.4f}, write "
        f"{timings['write']:.4f}), LOS {timings['los']:.4f} s (sample "
        f"{timings['los_sample']:.4f}, download {timings['los_download']:.4f}"
        f", upload {timings['los_upload']:.4f}, transfer "
        f"{timings['los_transfer']:.4f}); peak device memory {peak} bytes; "
        f"trace and record-fold launches {launches} = segments, one "
        f"trace-input launch, one resample, one sampler launch, one voxel "
        f"fold; on-disk median T_b ray {np.median(a[disk]):.4g} K, LOS "
        f"{np.median(b[disk]):.4g} K")
    del ray, los
    entries = {}

    (variables, xs, ys, zs, phi0), kw = scenes[0][0][:5], scenes[0][1]
    fill = kw.get("fill_nan", 0.0)
    worst = 0.0
    k = resample.resample_cubes(variables, xs, ys, zs, phi0, fill_nan=fill)
    for v, (name, cube) in enumerate(zip(MAS_VARIABLES, k)):
        want = resample.resample_cube_plain(*variables[v], xs, ys, zs, phi0,
                                            fill)
        worst = max(worst, hold_floats(
            "21", f"resample of {name} onto {n}^3 at extent "
            f"{p['grid_extent']} ({n % 16} planes past the last whole "
            f"16-plane slab), fill {fill}", cube, want, RESAMPLE_ULP_BAR))
        del want
    del k
    times = time_kernel(
        lambda: resample.resample_cubes(variables, xs, ys, zs, phi0,
                                        fill_nan=fill),
        lambda: resample.resample_cubes_plain(variables, xs, ys, zs, phi0,
                                              fill), reps=5)
    entries["resample_cube"] = kernel_entry(
        "21", f"resample, one launch of {len(variables)} variables onto "
        f"{n}^3", times, scene_bound([resample_bound(a, n)
                                      for a in variables]), worst)
    del scenes
    torch.cuda.empty_cache()

    args = firsts[0]
    del firsts
    rec_k, rows = hold_segment("21", f"first segment at dt {p['dt']}",
                               args, 0.99)
    times = time_kernel(lambda: trace_segment(*args),
                        lambda: trace_segment_plain(*args), reps=5)
    entries["trace_segment"] = kernel_entry(
        "21", f"trace segment ({args[2].shape[1]} rays, {args[5]} + "
        f"{args[7] - 1} x {args[6]} steps, {n}^3)", times,
        segment_bound_ms(args[0], args[1], args[2], rec_k, args[5],
                         args[6]), float(max(rows)))
    del args, rec_k
    torch.cuda.empty_cache()

    (variables, *queries), _ = samples[0]
    del samples
    points = queries[0].numel()
    worst = 0.0
    k = resample.sample_sph_many(variables, *queries)
    want = resample.sample_sph_many_plain(variables, *queries)
    for name, got, ref in zip(MAS_VARIABLES, k, want):
        worst = max(worst, hold_floats(
            "21", f"sampler, {name} at {points} points", got, ref,
            RESAMPLE_ULP_BAR))
    del k, want
    times = time_kernel(lambda: resample.sample_sph_many(variables,
                                                         *queries),
                        lambda: resample.sample_sph_many_plain(variables,
                                                               *queries))
    entries["sample_sph"] = kernel_entry(
        "21", f"sampler, one launch of {len(variables)} variables at "
        f"{points} points", times, sample_bound(variables, points), worst)
    del variables, queries
    torch.cuda.empty_cache()

    (args, kw), = folds
    del folds
    res, ref, times = time_fold(lambda: tf.fold_voxels(*args, **kw),
                                lambda: tf.fold_voxels_plain(*args, **kw))
    bound = fold_voxels_bound(*args, **kw)
    ds, nf, mechanism = args[0], args[5].shape[0], args[11]
    _, absd = hold_fold("21", f"voxel fold ({ds.shape[0]} voxels x "
                        f"{ds.shape[1]} pixels x {nf} frequency, mechanism "
                        f"{mechanism})", res, ref, mechanism, times, bound,
                        phase="21")
    entries["fold_voxels"] = dict(ms=times[1], wrapper_ms=times[0],
                                  plain_ms=times[2], bound_ms=bound[0],
                                  bound_by=bound[1], max_abs_err=absd)
    del args, kw, res, ref
    torch.cuda.empty_cache()
    out["highband"] = dict(wall=wall, peak_bytes=peak, launches=launches,
                           kernels=entries)


def dem_case(nz=200, nt=50, nf=100, mech=1, seed=5):
    """get_mw's arguments (lparms, rparms, parms, t, dem) for a DEM-mode
    line of sight, the case of tests/test_torch_get_mw.py at nz voxels, nt
    temperatures and nf frequencies from 150 MHz: a log-normal DEM per
    voxel; mechanism flags `mech` (3: free-free and gyroresonance, with B
    of 30-300 G)."""
    rng = np.random.default_rng(seed)
    t_grid = np.logspace(4.5, 6.8, nt)
    t_peak = 10 ** rng.uniform(5.2, 6.4, nz)
    em = 10 ** rng.uniform(24.0, 26.0, nz)
    prof = np.exp(-0.5 * (np.log(t_grid[:, None] / t_peak[None, :])
                          / 0.5) ** 2)
    w = np.gradient(t_grid)
    dem = em[None, :] * prof / np.sum(w[:, None] * prof, axis=0)
    ds = rng.uniform(5e8, 5e9, nz)
    parms = np.zeros((15, nz), order="F")
    parms[0] = ds
    parms[1] = np.sum(w[:, None] * dem * t_grid[:, None], axis=0) / em
    parms[2] = np.sqrt(em / ds)
    parms[3] = rng.uniform(0.5, 4.0, nz) * (75.0 if mech & 2 else 1.0)
    parms[4] = 70.0
    parms[6] = mech
    parms[7] = 30
    lparms = np.array([nz, nf, nt, 1, 0], np.int32)
    rparms = np.array([1e18, 150e6, 0.01])
    return (lparms, rparms, parms, t_grid,
            np.asfortranarray(dem).ravel(order="F"))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    t_all = time.perf_counter()
    phase_build()
    with torch.inference_mode():
        phase_small(out)
        phase_canonical(out)
        phase_segments(out)
        phase_pack(out)
        with tempfile.TemporaryDirectory() as tmp:
            one = phase_main(out, tmp)
        cubes = phase_map()
        with tempfile.TemporaryDirectory() as tmp:
            los6 = phase_los(tmp)
            phase_gyro(tmp)
            phase_compare(tmp)
        phase_per_step(out, cubes)
        del cubes
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            phase_sweep(tmp)
            scan_launches = phase_cli(tmp)
            phase_mesh(tmp, one)
            phase_float64(tmp)
        phase_exact()
        phase_harness()
        with tempfile.TemporaryDirectory() as tmp:
            phase_series(tmp)
            phase_fold(out, tmp, los6)
            phase_resample(out, tmp)
            phase_sample(out, tmp)
        phase_scans(out)
        with tempfile.TemporaryDirectory() as tmp:
            phase_counts(tmp)
        with tempfile.TemporaryDirectory() as tmp:
            phase_highband(out, tmp)
    say(f"total {time.perf_counter() - t_all:.1f} s")
    fold, vfold = out["fold"], out["voxel_fold"]
    kernels = [
        dict(name="trace_segment", source=KERNEL_SOURCE,
             replaces=KERNEL_REPLACES, launches=out["launches"],
             max_abs_err=out["max_abs_err"], ms=out["ms"],
             plain_ms=out["plain_ms"], bound_ms=out["bound_ms"],
             bound_by=out["bound_by"]),
        dict(out["pack"], name="pack_trace_inputs", source=KERNEL_SOURCE,
             replaces=PACK_REPLACES, launches=out["pack_launches"]),
        dict(fold, name="fold_records", source=FOLD_SOURCE,
             replaces=FOLD_REPLACES["records"],
             launches=out["fold_launches"]),
        dict(vfold, name="fold_voxels", source=FOLD_SOURCE,
             replaces=FOLD_REPLACES["voxels"])]
    launches = {"resample_cube": out["resample_launches"],
                "sample_sph": los6["sample_launches"],
                "valid_ds": scan_launches, "dem_scan": out["dem_launches"]}
    del los6
    kernels += [dict(out[name], name=name,
                     source=SCAN_SOURCE if name in ("valid_ds", "dem_scan")
                     else RESAMPLE_SOURCE, replaces=SCAN_REPLACES[name],
                     launches=launches[name]) for name in launches]
    say(json.dumps({"kernels": [
        dict(k, route="cuda", library_ms=None,
             bound_share=k["bound_ms"] / k["ms"]) for k in kernels]}))
    say(smi_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
