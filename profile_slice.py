#!/usr/bin/env python3
"""Measurements of the PyTorch/CUDA port on one NVIDIA GPU, beyond the
pass/fail checks of chip_smoke.py.

    python3 profile_slice.py [phase ...]   # from the repository root
                                           # on a card; default: all

  1. floor: the noise floor of the theta_mode='los' map that chip_smoke.py
     phase 7 holds to DV_BAR_GR (n_pix 32 x 600 steps on a b0_gauss =
     50 model's 128^3 cubes, nfreq 2), for mechanism 5 and for mechanism 7
     (gyroresonance). Against the plain map: the plain map on cubes
     multiplied by (1 + 1e-7 N(0,1)), and the map through the kernel. For
     each: lit values, max rel T_b, max and 99th percentile of |dV/I| and
     the count above 1e-4.
  2. s_mode: the kernel's canonical first segment with cumulative and
     with per-step S, timed in turns (median of 6 timings of 10
     launches), beside ptxas's registers and spills for each
     instantiation of the kernel; the two modes' records equal outside
     row 3 and their end states equal.
  3. mesh: the production slice over meshes of every visible card, one
     rank per card on nccl (chip_smoke.py's phase 12 with the shapes
     (n, 1) and (n/2, 2), the latter at nfreq 4, and dryrun_multichip(n)),
     each rank's stages and the straggler factor, against one process;
     on one card, phase 12 itself (2 and 4 ranks sharing it over gloo).
  4. fold: the transfer folds alone (chip_smoke.fold_cases, the record
     folds of chip_smoke.py phase 17 (a) and (a'), and the LOS chain's
     voxel fold, 400 voxels x 16,384 pixels x 4 frequencies), each the
     median of 5 timings of 20 wrapper calls by CUDA events (which, for a
     kernel of tens of microseconds, include the host's time to launch it)
     and the kernel's device time (the same launches queued behind a
     device sleep), in one process per tree: the tree of the parent
     commit, unpacked by `git archive` into PARENT_TREE (default
     _archive/parent; skipped if absent), and this one, in the turns
     parent, this, this, parent (in_trees). A case a tree's wrapper refuses is
     reported as refused. In this tree's first run, also every case's
     device time at each group size G (1, 2, 4, 8 lanes a ray), each held
     equal to the shipped G's carry (torch.equal; rtol 1e-6 with
     gyroresonance).
  5. resample: the scene kernels' device times (scene_kernel_times: the
     five variables' resample at 128^3 and 576^3 and their sample at
     chip_smoke.py phase 6's points, as the tree's pipeline launches them,
     and one variable alone) in the parent tree and in this one, in the
     turns parent, this, this, parent; then the layers of
     prepare_cubes on the host clock, each followed by a device
     synchronize: the HDF4 read of the five variables (a fresh MASModel),
     their upload with the grid axes, the one launch that resamples the
     five (csrc/resample_sph.cu) or the plain version, and
     _finalize_cubes; the two in turns, the median of 5 runs (3 for the
     sweep's sets) after a warm-up each, at 128^3 (the production map's
     set) and at each of the TbSpectra sweep's nine cube sets
     (256^3-576^3, phi0 -140); and the LOS chain's resample_mas_los under
     cProfile.
The card's name and power limit are printed first and last. Without a
CUDA device it exits 1.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke
from chip_smoke import (DV_BAR_GR, SLICE, canonical_scene, cuda_ms,
                        map_diff, plain_segments, say, segment_bound_ms,
                        smi_line)

PHASES = ("floor", "s_mode", "mesh", "fold", "resample")
# phases fold and resample: the parent tree's directory
PARENT_TREE = Path(os.environ.get("PARENT_TREE", "_archive/parent"))


def sass_mix(lib, top=16, kernel="ILb1ELb0ELi1EiE"):
    """Static SASS opcode counts (cuobjdump -sass) of one instantiation of
    the library's kernel, by default the main path's: cross-sections,
    cumulative S, 4 channels, 32-bit offsets. Its step loop is
    straight-line code, so the counts are about one step's instruction mix
    plus one record."""
    from raytracinggrff_tpu_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", lib._name],
                          capture_output=True, text=True, check=True).stdout
    body = next(sec for sec in sass.split("Function : ")
                if sec.startswith("_Z") and f"kernel{kernel}E" in
                sec.split()[0])
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     body)
    counts = collections.Counter(ops)
    return len(ops), counts.most_common(top)


def canonical_args(n_pix):
    from raytracinggrff_tpu_torch.tracer_segments import (initial_state,
                                                          prepare_trace_inputs)
    grid, f, start, kdir = canonical_scene(n_pix)
    tcube, scube = prepare_trace_inputs(f["wpe"], f["ne"], f["te"], f["b"],
                                        grid)
    state = initial_state(tcube, grid, 75e6, start, kdir)
    return tcube, scube, state, grid


# No phase calls busy_seconds: benchmark/tests/test_bench_yardstick.py
# imports it to check the benchmark's copy against it.
def busy_seconds(events):
    """Length of the union of the events' [start, end] intervals, in s."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6


def jittered(cubes, seed=0):
    """Each cube multiplied by (1 + 1e-7 N(0,1)), drawn in float64."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jitter(v):
        n = torch.randn(v.shape, generator=gen, device=v.device,
                        dtype=torch.float64)
        return (v.double() * (1.0 + 1e-7 * n)).float()
    return {k: tuple(jitter(c) for c in v) if k == "bvec" else jitter(v)
            for k, v in cubes.items()}


def phase_floor():
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
        map_diff("floor", f"mechanism {mech}, kernel vs plain", ref,
                 run(cubes), DV_BAR_GR)


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
    from raytracinggrff_tpu_torch.ops import _build
    from raytracinggrff_tpu_torch.ops import trace_segment as ts
    _, log = _build.build_library()
    usage = ptxas_usage(log)
    for name, line in sorted(usage.items()):
        say(f"[s_mode] ptxas {name}: {line}")
    for name in ("ILb1ELb0ELi1EiE", "ILb1ELb1ELi1EiE"):
        total, top = sass_mix(_build.library(), top=6, kernel=name)
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


def fold_inputs():
    """The fold cases' inputs on the card: chip_smoke.fold_cases and the
    LOS chain's voxel fold, {name: (fold, args, kw)}, fold 'records' or
    'voxels'."""
    cases = chip_smoke.fold_cases()
    with tempfile.TemporaryDirectory() as tmp:
        los = chip_smoke.phase_los(tmp)["los"]
        _, call = chip_smoke.los_chain_fold(los)
    cases["(c) LOS chain voxel fold"] = ("voxels", *call)
    return cases


def fold_times(variants):
    """Each fold case in this process's package: the median ms of 5
    timings of 20 wrapper calls by CUDA events ("shipped"), which at the
    sweep's size include the host's time to launch, and
    chip_smoke.device_ms ("device"), or None for both where the wrapper
    refuses the case; with `variants`, also the device time at every group
    size, each variant's carry held to the shipped one's. Returns
    {case: {variant: ms}}."""
    from raytracinggrff_tpu_torch.ops import transfer_fold as tf
    out = {}
    for name, (kind, args, kw) in fold_inputs().items():
        fold = getattr(tf, f"fold_{kind}")

        def run():
            res = fold(*args, **kw)
            return res[0] if kind == "records" else res

        try:
            ref = run()
        except ValueError as err:
            say(f"[fold] {name}: refused ({err})")
            out[name] = {"shipped": None, "device": None}
            continue
        out[name] = {"shipped": float(np.median([cuda_ms(run, reps=20)
                                                 for _ in range(5)])),
                     "device": chip_smoke.device_ms(run)}
        if not variants:
            continue
        gr = (kw["mechanism"] if kind == "records" else args[11]) & 2
        shipped = tf.group_size
        for g in (1, 2, 4, 8):
            tf.group_size = lambda *_, g=g: g
            try:
                for a, b in zip(run(), ref):
                    if gr:
                        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
                    else:
                        assert torch.equal(a, b), (name, g)
                out[name][f"G{g}"] = chip_smoke.device_ms(run)
            finally:
                tf.group_size = shipped
    return out


# run from a tree's directory: that tree's package, this tree's scripts;
# calls profile_slice.<argv[2]>(*argv[3:]) and prints its JSON result
TREE_CHILD = """\
import importlib.util, json, sys
from pathlib import Path
import torch
sys.path.insert(0, ".")
for name in ("chip_smoke", "profile_slice"):
    spec = importlib.util.spec_from_file_location(
        name, Path(sys.argv[1]).parent / f"{name}.py")
    sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[name])
with torch.inference_mode():
    res = getattr(sys.modules["profile_slice"], sys.argv[2])(*sys.argv[3:])
print("RESULT " + json.dumps(res))
"""


def in_trees(fn, *args):
    """profile_slice.`fn`(*args) in the parent tree (PARENT_TREE, if it is
    there) and in this one in the turns parent, this, this, parent, each in
    a process of its own run from that tree, so that it imports that
    tree's package and builds its kernels (and this tree's chip_smoke.py
    and profile_slice.py, which use only the package's public entries).
    `args` may be a callable of (label, turn) giving the arguments of that
    turn. Returns [(label, tree, result)] in the order run."""
    here = Path(__file__).resolve().parent
    trees = [("this", here)]
    if PARENT_TREE.is_dir():
        parent = PARENT_TREE.resolve()
        trees = [("parent", parent), ("this", here), ("this", here),
                 ("parent", parent)]
    else:
        say(f"[{fn}] no parent tree at {PARENT_TREE}; this tree only")
    out = []
    for turn, (label, tree) in enumerate(trees):
        argv = (args[0](label, turn, len(trees))
                if args and callable(args[0]) else args)
        proc = subprocess.run(
            [sys.executable, "-c", TREE_CHILD,
             str(Path(__file__).resolve()), fn, *argv],
            cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{fn} in {tree} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT "))
        out.append((label, tree, json.loads(line[7:])))
    return out


def phase_fold():
    """The fold cases in the parent tree and in this one, in turns
    (in_trees), this tree's first turn also at every group size."""
    def argv(label, turn, n_turns):
        first = label == "this" and turn == 1 or n_turns == 1
        return ("variants" if first else "shipped",)

    runs = collections.defaultdict(list)
    for turn, (label, tree, times) in enumerate(in_trees("fold_child",
                                                          argv)):
        runs[label].append(times)
        say(f"[fold] turn {turn} ({label}, {tree}): " + "; ".join(
            f"{case} refused" if t["device"] is None else
            f"{case} {t['shipped']:.4f} ms (device {t['device']:.4f})"
            for case, t in times.items()))
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"[fold] SM clock, its maximum and power after the runs: {clocks}")
    for case in runs["this"][0]:
        for kind in ("shipped", "device"):
            this = [r[case][kind] for r in runs["this"]]
            line = (f"[fold] {case}, {kind}: this tree "
                    f"{['%.4f' % t for t in this]} ms")
            par = [r[case][kind] for r in runs["parent"]]
            if par and None not in par:
                line += (f", parent {['%.4f' % t for t in par]} ms, this / "
                         f"parent {np.mean(this) / np.mean(par):.3f}")
            elif par:
                line += ", refused by the parent"
            say(line)
    for case, times in runs["this"][0].items():
        say(f"[fold] {case}, device ms by group size: " + ", ".join(
            f"{v} {t:.4f}" for v, t in times.items()
            if v not in ("shipped", "device")))


def fold_child(mode):
    """fold_times in a tree's process: mode 'variants' or 'shipped'."""
    return fold_times(mode == "variants")


def resample_layers(model_path, grid, phi0, kernel, bvec=False,
                    device="cuda"):
    """One prepare_cubes split into its layers, each on the host clock
    with the device drained after it: read (a fresh MASModel's five
    variables, MASVariable.from_file), upload (mas/model.scene_arrays and
    the grid axes), resample (the five cubes in one launch of
    ops/resample.resample_cubes, or resample_cubes_plain with kernel
    False), finalize (_finalize_cubes, and with bvec _bvec_image_cubes).
    Returns {layer: seconds}."""
    from raytracinggrff_tpu_torch.mas.model import MASModel, scene_arrays
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.pipeline import (_bvec_image_cubes,
                                                   _finalize_cubes)
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t = [time.perf_counter()]
    model = MASModel(model_path)
    names = ("rho", model.temperature_variable(), "br", "bt", "bp")
    variables = [model[v] for v in names]
    t.append(time.perf_counter())
    arrays = scene_arrays(variables, device)
    axes = [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in grid.axes()]
    sync()
    t.append(time.perf_counter())
    fn = resample.resample_cubes if kernel else resample.resample_cubes_plain
    raw = fn(arrays, *axes, phi0, None)
    sync()
    t.append(time.perf_counter())
    cubes = _finalize_cubes(*raw)
    if bvec:
        cubes += _bvec_image_cubes(*raw[2:], grid)
    sync()
    t.append(time.perf_counter())
    return dict(zip(("read", "upload", "resample", "finalize"),
                    np.diff(t).tolist()))


def scene_cases(model, many):
    """{case: a call} of the scene kernels at chip_smoke.py phase 18's
    shapes, through the tree's public wrappers (many: whether the tree has
    resample_cubes and sample_sph_many): the synthetic `model`'s five
    variables resampled onto each of chip_smoke.RESAMPLE_SETS and sampled
    at phase 6's 6,553,600 points, as the tree's pipeline runs them ("five":
    one launch with many, else five one-variable launches), and one
    variable alone ("one")."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas import model as mas
    from raytracinggrff_tpu_torch.ops import resample
    from raytracinggrff_tpu_torch.pipeline import resample_mas_los
    variables = [model[v] for v in chip_smoke.MAS_VARIABLES]
    scene = (mas.scene_arrays(variables, "cuda") if many else
             [v.device_arrays("cuda") for v in variables])
    cases = {}
    for n, extent, phi0 in chip_smoke.RESAMPLE_SETS:
        axes = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
                for a in UniformGrid.cube(extent, n).axes()]
        if many:
            cases[f"cube five {n}"] = functools.partial(
                resample.resample_cubes, scene, *axes, phi0, None)
        else:
            cases[f"cube five {n}"] = functools.partial(
                lambda axes, phi0: [resample.resample_cube(*v, *axes, phi0,
                                                           None)
                                    for v in scene], axes, phi0)
        cases[f"cube one {n}"] = functools.partial(
            resample.resample_cube, *scene[0], *axes, phi0, None)
    name = "sample_sph_many" if many else "sample_sph"
    with chip_smoke.captured(resample, name) as calls:
        resample_mas_los(model.path, n_pix=128, x_range=(-1.44, 1.44),
                         y_range=(-1.44, 1.44), n_z=400, dz0=3e-4,
                         phi0_offset=24.0, verbose=False, device="cuda")
    if many:
        (arrays, *queries), _ = calls[0]
        cases["sph five"] = functools.partial(resample.sample_sph_many,
                                              arrays, *queries)
    else:
        arrays = [c[0][:4] for c in calls]
        queries = calls[0][0][4:]
        cases["sph five"] = lambda: [resample.sample_sph(*v, *queries)
                                     for v in arrays]
    cases["sph one"] = functools.partial(resample.sample_sph, *arrays[0],
                                         *queries)
    return cases


def scene_kernel_times():
    """Device ms (chip_smoke.device_ms) of each of scene_cases in this
    process's package. Returns {case: ms}."""
    from raytracinggrff_tpu_torch.mas import model as mas
    from raytracinggrff_tpu_torch.ops import resample
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        model = mas.MASModel(mas.synthetic_mas_model(Path(tmp) / "corona"))
        cases = scene_cases(model, hasattr(resample, "resample_cubes"))
        for case, call in cases.items():
            out[case] = chip_smoke.device_ms(call, reps=5)
    return out


def phase_resample(sets=None, device="cuda"):
    """The scene kernels' device times in the parent tree and in this
    one, in turns (in_trees of scene_kernel_times); then the layers
    of prepare_cubes (resample_layers) through the kernel and through the
    plain version, in turns (plain, kernel, kernel, plain, ...), the
    median of `reps` runs each after a warm-up: at 128^3 (phi0 0, the
    production map's set, 5 runs) and at each of the TbSpectra sweep's
    nine cube sets (phi0 -140, 3 runs); or at `sets`, (grid_n, extent,
    phi0, reps) each (and then no kernel times)."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    if sets is None:
        runs = collections.defaultdict(list)
        for turn, (label, tree, times) in enumerate(in_trees(
                "scene_kernel_times")):
            runs[label].append(times)
            say(f"[resample] turn {turn} ({label}, {tree}): "
                + "; ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
        for case in runs["this"][-1]:
            this = [r[case] for r in runs["this"]]
            line = (f"[resample] {case}: this tree "
                    f"{['%.4f' % t for t in this]} ms")
            par = [r[case] for r in runs["parent"]]
            if par:
                line += (f", parent {['%.4f' % t for t in par]} ms, this / "
                         f"parent {np.mean(this) / np.mean(par):.3f}")
            say(line)
    sets = sets or [(128, 3.0, 0.0, 5)] + [
        (n, e, -140.0, 3) for n, e in chip_smoke.sweep_cube_sets()]
    with tempfile.TemporaryDirectory() as tmp:
        path = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
        total = collections.defaultdict(float)
        for j, (n, extent, phi0, reps) in enumerate(sets):
            grid = UniformGrid.cube(extent, n)
            runs = {True: [], False: []}
            for i in range(2 * reps + 2):
                kernel = i % 4 in (1, 2)
                res = resample_layers(path, grid, phi0, kernel,
                                      device=device)
                if i > 1:                  # the first two are warm-ups
                    runs[kernel].append(res)
            for kernel in (False, True):
                med = {k: float(np.median([r[k] for r in runs[kernel]]))
                       for k in runs[kernel][0]}
                whole = sum(med.values())
                label = "kernel" if kernel else "plain"
                if j:
                    total[label] += whole
                say(f"[resample] {n}^3 at extent {extent}, phi0 {phi0}, "
                    f"{label}: " + ", ".join(
                        f"{k} {v:.5f} s" for k, v in med.items())
                    + f"; all {whole:.5f} s (median of {reps})")
        say(f"[resample] the {len(sets) - 1} sets after the first (the "
            f"sweep's): plain {total['plain']:.4f} s, kernel "
            f"{total['kernel']:.4f} s")
        los_profile(Path(tmp), device)


def los_profile(tmp, device="cuda", top=12):
    """The LOS chain's resample_mas_los at chip_smoke.py phase 6's shapes
    under cProfile, after a warm-up: its wall time and the host functions
    with the most time of their own (a call that waits for the device,
    such as a copy to the host, holds that wait)."""
    import cProfile
    import pstats
    from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
    from raytracinggrff_tpu_torch.pipeline import resample_mas_los
    model = synthetic_mas_model(tmp / "corona_los")
    kw = dict(n_pix=128, x_range=(-1.44, 1.44), y_range=(-1.44, 1.44),
              n_z=400, dz0=3e-4, phi0_offset=24.0, verbose=False,
              device=device)
    resample_mas_los(model, **kw)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    resample_mas_los(model, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    say(f"[resample] resample_mas_los 128^2 x 400 under cProfile: {wall:.4f}"
        f" s; the functions with the most time of their own:")
    rows = sorted(stats.items(), key=lambda kv: -kv[1][2])[:top]
    for (path, line, name), (_, calls, own, cum, _) in rows:
        say(f"[resample]   {own:.4f} s own, {cum:.4f} s with callees, "
            f"{calls} calls: {Path(path).name}:{line} {name}")


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
        if "floor" in phases:
            phase_floor()
        if "s_mode" in phases:
            phase_s_mode()
        if "mesh" in phases:
            with tempfile.TemporaryDirectory() as tmp:
                model = synthetic_mas_model(Path(tmp) / "corona", timestep=2)
                phase_mesh(model, RayEmissionConfig(**SLICE))
        if "fold" in phases:
            phase_fold()
        if "resample" in phases:
            phase_resample()
    say(f"nvidia-smi: {smi_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
