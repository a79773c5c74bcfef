"""Driver of kind `compare`: one unit is one frequency of the straight-LOS
vs ray-tracing comparison as the CLI runs it,
cli/compare_los_raytracing.compare_frequency(model_path, freq, n_pix=...,
x_fov=..., phi0_offset=..., preset=..., ray_npz=<ray.npz>,
los_npz=<los.npz>, device=...): the ray-traced map and the straight-LOS
map, each written to its .npz (the CLI's png is left out), with the spans
of both.

The preset is the configuration's: grid_n, grid_extent, z_observer, dt,
n_steps, record_stride and seg_records of its "map", dz0 and n_z of its
"los"; the LOS map takes its pixels and field of view from "map", so a
configuration cut in "map" cuts both maps. Set-up writes the
seeded MAS model and runs one unit. Every unit's four cubes (T_b and V/I
of each map) are digested; the check holds every digest to the last
unit's, and the last unit's two .npz files, read back at a seeded sample
of pixels, to the plain references' maps of those pixels from the same
MAS arrays: benchmark/reference/map.py for the ray-traced map,
benchmark/reference/los.py for the straight-LOS map.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from raytracinggrff_tpu_torch.cli.compare_los_raytracing import (
    compare_frequency)
from raytracinggrff_tpu_torch.pipeline import RayEmissionConfig

from ..reference.los import los_pixels
from ..reference.map import map_pixels
from ..yardstick.compare import map_gaps
from .common import KEYS, limits, map_settings, sample, write_scene

# the map settings that compare_frequency takes from its arguments and the
# preset; it leaves the others at RayEmissionConfig's defaults
TAKEN = ("n_pix", "x_fov", "freq_hz", "phi0_offset", "grid_n",
         "grid_extent", "z_observer", "dt", "n_steps", "record_stride",
         "seg_records")
# what compare_frequency runs the LOS map at (synthetic_ff's defaults)
LOS_FIXED = dict(variable_spacing_z=True, nfreq=1, mechanism=5)


def preset(cell):
    """The map settings, the LOS settings and compare_frequency's preset
    of the cell. Refuses a configuration that asks for settings
    compare_frequency does not run."""
    run, los = map_settings(cell), dict(cell.config["los"])
    defaults = dataclasses.asdict(RayEmissionConfig())
    for key, value in run.items():
        if key in TAKEN:
            continue
        want = run["freq_hz"] if key == "freq0" else defaults[key]
        if value != want:
            raise ValueError(f"compare_frequency runs {key}={want!r}, the "
                             f"configuration asks for {value!r}")
    for key, want in LOS_FIXED.items():
        if los[key] != want:
            raise ValueError(f"compare_frequency runs the LOS map at "
                             f"{key}={want!r}, not {los[key]!r}")
    p = {k: run[k] for k in ("grid_n", "grid_extent", "z_observer", "dt",
                             "n_steps", "record_stride", "seg_records")}
    p.update(dz0=los["dz0"], n_z=los["n_z"])
    return run, los, p


def digest(*results):
    h = hashlib.sha256()
    for result in results:
        for k in KEYS:
            h.update(np.ascontiguousarray(result[k]).tobytes())
    return h.hexdigest()


def setup(cell, seed, device, workdir):
    run, los, p = preset(cell)
    arrays, mesh, model_dir = write_scene(cell, seed, workdir)
    ctx = SimpleNamespace(
        run=run, los=los, preset=p, arrays=arrays, mesh=mesh,
        model_dir=str(model_dir), ray_npz=str(workdir / "ray.npz"),
        los_npz=str(workdir / "los.npz"), device=device, digests=[],
        pixels=sample(seed, run["n_pix"] ** 2,
                      cell.traffic["check"]["pixels"]))
    compare_once(ctx)                          # warm-up
    ctx.digests.clear()
    from ..harness import lap
    lap("warm-up comparison")
    return ctx


def compare_once(ctx):
    run = ctx.run
    timings = {}
    t0 = time.perf_counter()
    ray, los = compare_frequency(
        ctx.model_dir, run["freq_hz"], n_pix=run["n_pix"],
        x_fov=run["x_fov"], phi0_offset=run["phi0_offset"], preset=ctx.preset,
        ray_npz=ctx.ray_npz, los_npz=ctx.los_npz, verbose=False,
        device=ctx.device, timings=timings)
    wall = time.perf_counter() - t0
    ctx.digests.append(digest(ray, los))
    ok = all(np.isfinite(r[k]).all() for r in (ray, los) for k in KEYS)
    return {"wall": wall, "nfreq": 1, "timings": timings, "ok": ok}


def unit(ctx, run):
    return compare_once(ctx)


def collect(ctx, run):
    pass


def answers(ctx):
    """((T_b, V/I) of the ray-traced map, (T_b, V/I) of the LOS map) of
    the last unit's .npz files at the sampled pixels."""
    out = []
    for path in (ctx.ray_npz, ctx.los_npz):
        with np.load(path) as f:
            nf = f["emission_cube"].shape[-1]
            cubes = (f[k].reshape(-1, nf)[ctx.pixels] for k in KEYS)
            out.append(tuple(cubes))
    return tuple(out)


def reference(ctx, dtype=torch.float32):
    """The plain references' ((T_b, V/I), (T_b, V/I)) at the sampled
    pixels: the ray-traced map and the straight-LOS map."""
    from ..harness import note
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    run = dict(ctx.run, **ctx.preset)
    t0 = time.perf_counter()
    ray = map_pixels(ctx.arrays, ctx.mesh, run, ctx.pixels, ctx.device,
                     dtype)
    t1 = time.perf_counter()
    los = los_pixels(ctx.arrays, ctx.mesh, run, ctx.los, ctx.pixels,
                     ctx.device, dtype)
    note(f"reference: {len(ctx.pixels)} pixels of the ray-traced map in "
         f"{t1 - t0:.3f} s, of the LOS map in {time.perf_counter() - t1:.3f}"
         f" s")
    return ray, los


def gaps(got, want):
    """The gaps of the ray-traced map (tb_gap, vi_gap) and of the LOS map
    (los_tb_gap, los_vi_gap)."""
    out = map_gaps(got[0][0], want[0][0], got[0][1], want[0][1])
    los = map_gaps(got[1][0], want[1][0], got[1][1], want[1][1])
    out.update({f"los_{k}": v for k, v in los.items()})
    return out


def check(ctx, run):
    """{number: (value, limit)}: units whose maps differ from the last
    unit's, and the last unit's two .npz files at the sampled pixels
    against the plain references'."""
    differing = sum(d != ctx.digests[-1] for d in ctx.digests)
    got = answers(ctx)
    want = ctx.want = reference(ctx)
    lim = limits(run.cell)
    return {"maps_differing": (differing, 0),
            **{k: (v, lim[k]) for k, v in gaps(got, want).items()}}
