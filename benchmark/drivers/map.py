"""Driver of kind `map`: one unit is one emission map made from the MAS
directory as the CLI makes it, run_ray_tracing_emission(model_path=...,
out_path=<map.npz>, device=...), with the stage timings it offers.

Set-up writes the seeded MAS model and makes one map. Every map's T_b and
V/I cubes are digested; the check holds every digest to the last map's,
and the last map, read back from its .npz, at a seeded sample of pixels,
to the plain reference's map of those pixels from the same MAS arrays.
"""

from __future__ import annotations

import hashlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                               run_ray_tracing_emission)

from ..reference.map import map_pixels
from ..yardstick.compare import map_gaps
from .common import KEYS, limits, map_settings, sample, write_scene


def digest(result):
    h = hashlib.sha256()
    for k in KEYS:
        h.update(np.ascontiguousarray(result[k]).tobytes())
    return h.hexdigest()


def setup(cell, seed, device, workdir):
    run = map_settings(cell)
    arrays, mesh, model_dir = write_scene(cell, seed, workdir)
    ctx = SimpleNamespace(
        run=run, arrays=arrays, mesh=mesh, model_dir=str(model_dir),
        config=RayEmissionConfig(**run), out=str(workdir / "map.npz"),
        device=device, digests=[],
        pixels=sample(seed, run["n_pix"] ** 2, cell.traffic["check"]["pixels"]))
    make_map(ctx)                              # warm-up
    ctx.digests.clear()
    from ..harness import lap
    lap("warm-up map")
    return ctx


def make_map(ctx):
    timings = {}
    t0 = time.perf_counter()
    result = run_ray_tracing_emission(
        model_path=ctx.model_dir, config=ctx.config, out_path=ctx.out,
        verbose=False, device=ctx.device, timings=timings)
    wall = time.perf_counter() - t0
    ctx.digests.append(digest(result))
    ok = all(np.isfinite(result[k]).all() for k in KEYS)
    return {"wall": wall, "nfreq": ctx.config.nfreq, "timings": timings,
            "ok": ok}


def unit(ctx, run):
    return make_map(ctx)


def collect(ctx, run):
    pass


def answers(ctx):
    """(T_b, V/I) of the last map's .npz at the sampled pixels."""
    with np.load(ctx.out) as f:
        nf = f["emission_cube"].shape[-1]
        return (f["emission_cube"].reshape(-1, nf)[ctx.pixels],
                f["emission_polVI_cube"].reshape(-1, nf)[ctx.pixels])


def reference(ctx, dtype=torch.float32):
    """The plain reference's (T_b, V/I) at the sampled pixels."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return map_pixels(ctx.arrays, ctx.mesh, ctx.run, ctx.pixels, ctx.device,
                      dtype)


def gaps(got, want):
    return map_gaps(got[0], want[0], got[1], want[1])


def check(ctx, run):
    """{number: (value, limit)}: maps whose T_b and V/I differ from the
    last map's, and the last map's .npz at the sampled pixels against the
    plain reference's."""
    from ..harness import note
    differing = sum(d != ctx.digests[-1] for d in ctx.digests)
    got = answers(ctx)
    t0 = time.perf_counter()
    want = ctx.want = reference(ctx)
    note(f"reference: {len(ctx.pixels)} pixels in "
         f"{time.perf_counter() - t0:.3f} s")
    lim = limits(run.cell)
    return {"maps_differing": (differing, 0),
            **{k: (v, lim[k]) for k, v in gaps(got, want).items()}}
