"""Driver of kind `trace`: one unit is the whole trace of the image
plane's rays through the configuration's cubes, as the program's harness
runs it: tracer_segments.iter_trace_segments segment by segment, with one
chained device reduction a segment, ending in a synchronize.

Set-up writes the seeded MAS model, resamples it to the cubes with the
program's prepare_cubes and runs one trace. The chained reduction copies
the records of a seeded sample of rays into one buffer, and a checksum of
its bits is kept for every trace. The check holds every trace's checksum
to the last one's, and the last trace's sampled records to the plain
reference's trace of the same rays from the same MAS arrays.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.mas.model import MASModel
from raytracinggrff_tpu_torch.pipeline import prepare_cubes
from raytracinggrff_tpu_torch.tracer_segments import (iter_trace_segments,
                                                      segment_plan)

from ..reference.map import as_numpy, trace_pixels
from ..reference.scene import image_ray_starts
from ..yardstick.compare import record_gaps
from ..yardstick.roofline import segment_bound_ms, steps_run
from .common import limits, map_settings, sample, write_scene

KERNEL = "trace_segment_kernel"


def setup(cell, seed, device, workdir):
    from ..harness import lap
    run = map_settings(cell)
    arrays, mesh, model_dir = write_scene(cell, seed, workdir)
    grid = UniformGrid.cube(run["grid_extent"], run["grid_n"])
    cubes = prepare_cubes(MASModel(model_dir), grid, run["phi0_offset"],
                          verbose=False, device=device)
    lap("the program's cubes resampled")
    _, _, start, kdir = image_ray_starts(run["n_pix"], run["x_fov"],
                                         run["z_observer"])
    n_rays = start.shape[0]
    rays = sample(seed, n_rays, cell.traffic["check"]["rays"])
    plan, n_records = segment_plan(run["n_steps"], run["record_stride"],
                                   run["seg_records"])
    ctx = SimpleNamespace(
        run=run, arrays=arrays, mesh=mesh, grid=grid, cubes=cubes,
        start=start, kdir=kdir, rays=rays, plan=plan,
        idx=torch.as_tensor(rays, device=device),
        kept=torch.empty((n_records, 8, len(rays)), dtype=torch.float32,
                         device=device),
        checksums=[], live=None, traced_units=0, device=device,
        ray_steps=n_rays * steps_run(run["n_steps"], run["record_stride"]))
    trace_once(ctx, count_live=False)          # warm-up
    ctx.checksums.clear()
    lap("warm-up trace")
    return ctx


def trace_once(ctx, count_live):
    run = ctx.run
    live = []
    row = 0
    for recs in iter_trace_segments(
            ctx.cubes["omega_pe"], ctx.cubes["ne"], ctx.cubes["te"],
            ctx.cubes["b"], ctx.grid, run["freq_hz"], ctx.start, ctx.kdir,
            run["dt"], run["n_steps"], run["record_stride"],
            trace_crosssections=True, perturb_ratio=run["perturb_ratio"],
            seg_records=run["seg_records"]):
        rps = recs.shape[0]
        torch.index_select(recs, 2, ctx.idx, out=ctx.kept[row:row + rps])
        if count_live:
            live.append((recs[:, 3] > 0).sum(dim=1))
        row += rps
    ctx.checksums.append(ctx.kept.view(torch.int32).sum(dtype=torch.int64))
    if count_live:
        ctx.live = (live if ctx.live is None
                    else [a + b for a, b in zip(ctx.live, live)])
        ctx.traced_units += 1
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def unit(ctx, run):
    t0 = time.perf_counter()
    trace_once(ctx, count_live=run.trace)
    return {"wall": time.perf_counter() - t0, "ray_steps": ctx.ray_steps}


def collect(ctx, run):
    """The trace kernel's least time over the traced window, from each
    segment's live rays (every trace runs the same rays, so a trace's
    counts are the window's over the traces)."""
    if ctx.live is None:
        return
    n_rays = ctx.start.shape[0]
    nx, ny, nz = ctx.grid.shape
    bound_ms = 0.0
    kinds = set()
    for (n_first, rps), live in zip(ctx.plan, ctx.live):
        per_trace = live.double().cpu().numpy() / ctx.traced_units
        ms, kind = segment_bound_ms(nx * ny * nz * 4, nx * ny * nz * 4, 4,
                                    7 * n_rays, rps * 8 * n_rays, per_trace,
                                    n_first, ctx.run["record_stride"])
        bound_ms += ms * ctx.traced_units
        kinds.add(kind)
    kernel_us = sum(us for name, us in run.kernel_us.items()
                    if KERNEL in name)
    run.extra.update(trace_bound_ms=bound_ms,
                     trace_kernel_ms=kernel_us / 1e3,
                     trace_bound_by=sorted(kinds))
    from ..harness import note
    note(f"trace kernel: bound {bound_ms:.3f} ms by {sorted(kinds)}, "
         f"device time {kernel_us / 1e3:.3f} ms over "
         f"{ctx.traced_units} traces")


def answers(ctx):
    """The last trace's records of the sampled rays, rows 0-6, as numpy;
    drops the program's cubes."""
    got = as_numpy(ctx.kept)[:, :7]
    ctx.cubes = ctx.kept = None
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return got


def reference(ctx, dtype=torch.float32):
    """The plain reference's records of the sampled rays, rows 0-6."""
    return as_numpy(trace_pixels(ctx.arrays, ctx.mesh, ctx.run, ctx.rays,
                                 ctx.device, dtype))[:, :7]


def gaps(got, want):
    return record_gaps(got, want)


def check(ctx, run):
    """{number: (value, limit)}: traces whose sampled records differ from
    the last trace's, and the last trace's sampled records against the
    plain reference's."""
    from ..harness import note
    sums = torch.stack(ctx.checksums)
    differing = int((sums != sums[-1]).sum())
    got = answers(ctx)
    t0 = time.perf_counter()
    want = ctx.want = reference(ctx)
    note(f"reference: {len(ctx.rays)} rays traced in "
         f"{time.perf_counter() - t0:.3f} s")
    lim = limits(run.cell)
    return {"traces_differing": (differing, 0),
            **{k: (v, lim[k]) for k, v in gaps(got, want).items()}}
