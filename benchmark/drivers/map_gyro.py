"""Driver of kind `map_gyro`: the map driver's unit (one emission map
made from the MAS directory as the CLI makes it, written to its .npz),
held to the gyroresonance reference (benchmark/reference/gyro.py), which
folds mechanism 7 with theta taken per record from B and the wave vector.

Set-up, the unit, the answers and the gaps are the map driver's; the
reference and the check are this map's.
"""

from __future__ import annotations

import time

import torch

from ..reference.gyro import map_pixels
from .common import limits
from .map import answers, collect, gaps, setup, unit  # noqa: F401


def reference(ctx, dtype=torch.float32):
    """The gyroresonance reference's (T_b, V/I) at the sampled pixels."""
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return map_pixels(ctx.arrays, ctx.mesh, ctx.run, ctx.pixels, ctx.device,
                      dtype)


def check(ctx, run):
    """{number: (value, limit)}: maps whose T_b and V/I differ from the
    last map's, and the last map's .npz at the sampled pixels against the
    gyroresonance reference's."""
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
