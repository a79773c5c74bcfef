#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU, beyond the
pass/fail checks of chip_smoke.py.

    python3 profile_slice.py [phase ...]   # from the repository root
                                           # on a card; default: all

  1. spread: the production slice of chip_smoke.py (256^2 rays x 5000
     steps x 128^3 cube, nfreq 3) from a synthetic MAS model; one warm-up
     run, then 5 timed runs, with the median and quartiles of each stage.
  2. profile: one more run of the slice under torch.profiler; the time the
     device was busy (the union of its kernel and copy intervals) over the
     run's wall time, the number of device kernels and the kernels with
     the most device time.
  3. cache: the kernel's per-ray cell cache, and FMA contraction. Four
     builds of the kernel (CACHE_VARIANTS: the uncached design, forced
     to miss on every evaluation by -DRGRFF_CACHE_OFF, and the shipped
     cache, each with nvcc's FMA contraction, FMA_NVCC_FLAGS, and with
     -fmad=false, NVCC_FLAGS), with their SASS opcode counts
     (cuobjdump), are timed in turns, median of 6 timings of 10 launches
     (4 at 512^2), on the canonical first segment (65,536 rays x 631
     steps) at 256^2 and 512^2 rays, and on a uniform 2^3 cube whose 8
     voxels fill one 128-byte line (the no-gather floor), each beside the
     segment's bound and the SM clock read just after the timings. Each
     build's records are held against the shipped build's, and on the
     canonical 256^2 segment against the plain version's. A counting
     build (-DRGRFF_COUNT_CACHE) gives the hit rate per evaluation kind
     (central, perturbed) on each scene and over the production slice's 8
     segments.
  4. floor: the noise floor of the theta_mode='los' map that chip_smoke.py
     phase 7 holds to DV_BAR_GR (n_pix 32 x 600 steps on a b0_gauss =
     50 model's 128^3 cubes, nfreq 2), for mechanism 5 and for mechanism 7
     (gyroresonance). Against the plain map: the plain map on cubes
     multiplied by (1 + 1e-7 N(0,1)), and the map through the shipped
     build (-fmad=false) and the FMA build. For each: lit values, max rel T_b,
     max and 99th percentile of |dV/I| and the count above 1e-4.
  5. s_mode: the shipped build's canonical first segment with cumulative
     and with per-step S, timed in turns (median of 6 timings of 10
     launches), beside ptxas's registers and spills for each
     instantiation of the kernel; the two modes' records equal outside
     row 3 and their end states equal.
  6. sweep: the whole TbSpectra sweep (chip_smoke.py's phase 10 at all
     30 frequencies: one cli/tb_spectra.run_sweep at its CLI defaults,
     lattice presets, no pngs) from a synthetic MAS model: per frequency
     the preset, records, stage times, segments and peak device memory;
     the sweep's wall time, records, segments and kernel launches.
  7. mesh: the production slice over meshes of every visible card, one
     rank per card on nccl (chip_smoke.py's phase 12 with the shapes
     (n, 1) and (n/2, 2), the latter at nfreq 4, and dryrun_multichip(n)),
     each rank's stages and the straggler factor, against one process;
     on one card, phase 12 itself (2 and 4 ranks sharing it over gloo).
The card's name and power limit are printed first and last. Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import (DV_BAR_GR, SLICE, build_all, canonical_scene,
                        compare_records, cuda_ms, kernel_library, map_diff,
                        plain_segments, say, segment_bound_ms, smi_line)

STAGES = ("wall", "resample", "trace", "transfer", "finish")
PHASES = ("spread", "profile", "cache", "floor", "s_mode", "sweep",
          "mesh")
# phase cache: flags added to FMA_NVCC_FLAGS for each build; "fma" adds
# none, and "shipped" is NVCC_FLAGS (-fmad=false)
CACHE_VARIANTS = {
    "uncached": ("-DRGRFF_CACHE_OFF",),
    "uncached_nofma": ("-DRGRFF_CACHE_OFF", "-fmad=false"),
    "fma": (),
    "shipped": ("-fmad=false",),
}


def sass_mix(lib, top=16, kernel="ILb1ELb0ELi1EiE"):
    """Static SASS opcode counts (cuobjdump -sass) of one instantiation of
    the library's kernel, by default the main path's: cross-sections,
    cumulative S, 4 channels, 32-bit offsets. Its step loop is
    straight-line code, so the counts are about one step's instruction mix
    plus one record."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    cuobjdump = Path(ts._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    body = next(sec for sec in sass.split("Function : ")
                if sec.startswith("_Z") and f"kernel{kernel}E" in
                sec.split()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     body)
    counts = collections.Counter(ops)
    return len(ops), counts.most_common(top)


def flag_sets():
    """The builds of phase cache and the shipped build's counting twin
    ("count")."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    sets = {name: ts.FMA_NVCC_FLAGS + defs
            for name, defs in CACHE_VARIANTS.items()}
    assert sets["shipped"] == ts.NVCC_FLAGS
    sets["count"] = ts.NVCC_FLAGS + ("-DRGRFF_COUNT_CACHE",)
    return sets


def uniform_scene(n_pix):
    """The canonical rays in a uniform medium (omega_pe half the 75 MHz
    wave's) on a 2^3 cube of the same extent: every evaluation reads the
    same 8 voxels, one 128-byte line."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.pipeline import image_ray_starts
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid = UniformGrid.cube(3.0, 2)
    full = torch.full(grid.shape, 1.0, device="cuda")
    tcube, scube = prepare_trace_inputs(full * (np.pi * 75e6), full * 1e8,
                                        full * 1.4e6, full, grid)
    _, _, start, kdir = image_ray_starts(n_pix, 1.44, 3.0)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    return tcube, scube, state, grid


def canonical_args(n_pix):
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid, f, start, kdir = canonical_scene(n_pix)
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    return tcube, scube, state, grid


def hit_rates(lib, fn):
    """[central, perturbed] hit rates and evaluation counts of fn()'s
    launches through the counting library `lib`."""
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    ts.trace_segment.cache_counts = None
    with kernel_library(lib):
        fn()
    ev_c, miss_c, ev_p, miss_p = ts.trace_segment.cache_counts.tolist()
    return ([1 - miss_c / max(ev_c, 1), 1 - miss_p / max(ev_p, 1)],
            [ev_c, ev_p])


def phase_cache(libs, model, cfg):
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    names = list(CACHE_VARIANTS)
    for name in names:
        total, top = sass_mix(libs[name])
        say(f"[cache] {name} SASS: {total} instructions; "
            + ", ".join(f"{op} {n}" for op, n in top))
    for n_pix in (256, 512):
        reps = 10 if n_pix == 256 else 4
        scenes = {"canonical": canonical_args(n_pix),
                  "uniform": uniform_scene(n_pix)}
        for scene, (tcube, scube, state, grid) in scenes.items():
            args = (tcube, scube, state, grid, 6e-3, 1, 10, 64)
            times = {name: [] for name in names}
            for turn in range(6):
                for name in (names if turn % 2 == 0 else names[::-1]):
                    with kernel_library(libs[name]):
                        times[name].append(cuda_ms(
                            lambda: ts.trace_segment(*args), reps=reps))
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                 "power.draw", "--format=csv,noheader"], capture_output=True,
                text=True, check=True).stdout.strip()
            with kernel_library(libs["shipped"]):
                _, rec_ref = ts.trace_segment(*args)
            bound_ms, bound_by = segment_bound_ms(tcube, scube, state,
                                                  rec_ref, 1, 10)
            tag = f"[cache] {n_pix}^2 {scene}"
            say(f"{tag}: bound {bound_ms:.4f} ms ({bound_by}); SM clock, "
                f"its maximum and power just after the timings: {clocks}")
            rec_plain = None
            if n_pix == 256 and scene == "canonical":
                _, rec_plain = ts.trace_segment_plain(*args)
            for name in names:
                with kernel_library(libs[name]):
                    _, rec = ts.trace_segment(*args)
                _, worst = compare_records(rec, rec_ref)
                med = float(np.median(times[name]))
                say(f"{tag} {name}: ms {['%.4f' % t for t in times[name]]} "
                    f"median {med:.4f}, {bound_ms / med:.4f} of the bound; "
                    f"max |diff| per row vs shipped "
                    f"{['%.3g' % w for w in worst]}")
                if rec_plain is not None:
                    ok, worst = compare_records(rec, rec_plain)
                    say(f"{tag} {name}: {ok.mean():.6f} of rays agree with "
                        f"plain; max |diff| per row "
                        f"{['%.3g' % w for w in worst]}")
            rates, evals = hit_rates(libs["count"],
                                     lambda: ts.trace_segment(*args))
            say(f"{tag} hit rate central {rates[0]:.5f} of {evals[0]}, "
                f"perturbed {rates[1]:.5f} of {evals[1]} evaluations")
        del scenes
        torch.cuda.empty_cache()
    rates, evals = hit_rates(libs["count"], lambda: run_slice(model, cfg))
    say(f"[cache] production slice (8 segments) hit rate central "
        f"{rates[0]:.5f} of {evals[0]}, perturbed {rates[1]:.5f} of "
        f"{evals[1]} evaluations")


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
            map_diff("floor", f"mechanism {mech}, plain on jittered cubes "
                     f"vs plain", ref, run(noisy), DV_BAR_GR)
        for name, lib in libs.items():
            with kernel_library(lib):
                map_diff("floor", f"mechanism {mech}, kernel {name} vs "
                         f"plain", ref, run(cubes), DV_BAR_GR)


def ptxas_usage(log):
    """{kernel template arguments: ptxas usage line} from a build log, for
    the trace_segment_kernel instantiations (e.g. 'ILb1ELb0ELi1EiE':
    cross-sections, cumulative S, 4 channels, 32-bit offsets)."""
    usage, current, spills = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*trace_segment_kernel"
                      r"(I\w+?E)Ev", line)
        if m:
            current, spills = m.group(1), ""
        elif current and "spill" in line:
            spills = line.strip()
        elif current and "Used" in line and "registers" in line:
            usage[current] = (line.split("info    :")[-1].strip() + "; "
                              + spills)
            current = None
    return usage


def phase_s_mode():
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    _, log = ts.build_library()
    usage = ptxas_usage(log)
    for name, line in sorted(usage.items()):
        say(f"[s_mode] ptxas {name}: {line}")
    for name in ("ILb1ELb0ELi1EiE", "ILb1ELb1ELi1EiE"):
        total, top = sass_mix(ts._library(), top=6, kernel=name)
        say(f"[s_mode] SASS {name}: {total} instructions; "
            + ", ".join(f"{op} {n}" for op, n in top))
    tcube, scube, state, grid = canonical_args(256)
    args = (tcube, scube, state, grid, 6e-3, 1, 10, 64)
    modes = ("cumulative", "per_step")
    times = {m: [] for m in modes}
    for turn in range(6):
        for m in (modes if turn % 2 == 0 else modes[::-1]):
            times[m].append(cuda_ms(
                lambda: ts.trace_segment(*args, s_mode=m), reps=10))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    st_c, rec_c = ts.trace_segment(*args)
    st_p, rec_p = ts.trace_segment(*args, s_mode="per_step")
    rows = [0, 1, 2, 4, 5, 6, 7]
    same = (torch.equal(st_c, st_p)
            and torch.equal(rec_c[:, rows].nan_to_num(-7.0),
                            rec_p[:, rows].nan_to_num(-7.0)))
    bound_ms, bound_by = segment_bound_ms(tcube, scube, state, rec_c, 1, 10)
    say(f"[s_mode] canonical 256^2 segment: bound {bound_ms:.4f} ms "
        f"({bound_by}); SM clock, its maximum and power just after the "
        f"timings: {clocks}; records outside row 3 and end states equal "
        f"across modes: {same}")
    for m in modes:
        med = float(np.median(times[m]))
        say(f"[s_mode] {m}: ms {['%.4f' % t for t in times[m]]} median "
            f"{med:.4f}, {bound_ms / med:.4f} of the bound")
    assert same


def phase_sweep():
    """All 30 maps of the TbSpectra sweep through chip_smoke's phase 10 (one
    run_sweep, so cube sets are reused as the CLI does; no kernel-vs-plain
    holds), and the totals."""
    with tempfile.TemporaryDirectory() as tmp:
        timings, wall = chip_smoke.phase_sweep(tmp, indices=range(30),
                                               compare=())
    total = {k: sum(t[k] for t in timings)
             for k in ("records", "resample", "trace", "transfer", "finish",
                       "segments")}
    say(f"[sweep] 30 maps: wall {wall:.3f} s; resample "
        f"{total['resample']:.3f} s, trace {total['trace']:.3f} s, transfer "
        f"{total['transfer']:.3f} s, finish {total['finish']:.3f} s; "
        f"{total['records']} records, {total['segments']} segments; peak "
        f"device memory {max(t['peak_bytes'] for t in timings) / 2 ** 30:.3f}"
        f" GiB")


def phase_mesh(model, cfg):
    from raytracinggrff_tpu_torch.pipeline import run_ray_tracing_emission
    n = torch.cuda.device_count()
    one = run_ray_tracing_emission(model_path=model, config=cfg,
                                   verbose=False, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        if n > 1:
            chip_smoke.phase_mesh(tmp, one, backend=None,
                                  shapes=((n, 1), (n // 2, 2)))
        else:
            chip_smoke.phase_mesh(tmp, one)


def main(argv=None):
    phases = sys.argv[1:] if argv is None else argv
    phases = phases or list(PHASES)
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        print(f"profile_slice: unknown phases {unknown}; choose from "
              f"{PHASES}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device; nothing run", file=sys.stderr)
        return 1
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig
    say(f"nvidia-smi: {smi_line()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    with torch.inference_mode():
        libs = (build_all(flag_sets())
                if {"cache", "floor"} & set(phases) else {})
        with tempfile.TemporaryDirectory() as tmp:
            model = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
            cfg = RayEmissionConfig(**SLICE)
            if "spread" in phases:
                phase_spread(model, cfg)
            if "profile" in phases:
                phase_profile(model, cfg)
            if "cache" in phases:
                phase_cache(libs, model, cfg)
            if "s_mode" in phases:
                phase_s_mode()
            if "sweep" in phases:
                phase_sweep()
            if "mesh" in phases:
                phase_mesh(model, cfg)
        if "floor" in phases:
            phase_floor({name: libs[name] for name in ("shipped", "fma")})
    say(f"nvidia-smi: {smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
