"""Driver of kind `sweep`: one unit is one whole TbSpectra sweep,
cli/tb_spectra.run_sweep(model_path, freqs, out_dir, ...) as the CLI runs
it, writing each map's .npz (the CLI's pngs are left out) into a
directory of the sweep's own, with its per-map timings.

Set-up writes the seeded MAS model and runs one sweep. Once the window
has closed, every sweep's .npz files are read back: a sweep with a map
that is not finite counts as failed, and each sweep's maps are digested.
The check holds every digest to the last sweep's, and a seeded sample of
the last sweep's maps, at a seeded sample of pixels, to the plain
reference's maps of those pixels, each at the preset the reference works
out for its frequency.
"""

from __future__ import annotations

import hashlib
import time
from types import SimpleNamespace

import numpy as np
import torch

from raytracinggrff_tpu_torch.cli.tb_spectra import run_sweep

from ..reference.map import map_pixels
from ..reference.presets import sweep_frequencies, sweep_preset
from ..yardstick.compare import map_gaps
from .common import KEYS, limits, sample, write_scene


def setup(cell, seed, device, workdir):
    sw = cell.config["sweep"]
    arrays, mesh, model_dir = write_scene(cell, seed, workdir)
    freqs = sweep_frequencies(sw["fmin_mhz"], sw["fmax_mhz"], sw["n_freq"])
    chk = cell.traffic["check"]
    ctx = SimpleNamespace(
        sw=sw, arrays=arrays, mesh=mesh, model_dir=str(model_dir),
        freqs=freqs, out_root=workdir / "sweep", n_sweeps=0, device=device,
        rows=None, digests=[], maps=sample(seed, len(freqs), chk["maps"]),
        pixels=sample(seed + 1, sw["n_pix"] ** 2, chk["pixels"]))
    sweep_once(ctx)                            # warm-up
    from ..harness import lap
    lap("warm-up sweep")
    return ctx


def sweep_once(ctx):
    """One sweep into a new directory, so that each sweep's files are its
    own: run_sweep raises where a map's .npz was not written."""
    sw = ctx.sw
    timings = []
    out_dir = ctx.out_root / f"{ctx.n_sweeps:04d}"
    ctx.n_sweeps += 1
    t0 = time.perf_counter()
    rows = run_sweep(ctx.model_dir, ctx.freqs, out_dir,
                         n_pix=sw["n_pix"], phi0_offset=sw["phi0_offset"],
                         s_input_on=sw["s_input_on"],
                         exact_presets=sw["exact_presets"],
                         device=ctx.device, timings=timings, verbose=False)
    wall = time.perf_counter() - t0
    ctx.rows = rows
    return {"wall": wall, "timings": timings, "rows": rows}


def unit(ctx, run):
    return sweep_once(ctx)


def read_back(rows):
    """(every map finite, a digest of the sweep's T_b and V/I cubes) from
    its .npz files."""
    h = hashlib.sha256()
    finite = True
    for r in rows:
        with np.load(r["npz"]) as f:
            for k in KEYS:
                a = np.ascontiguousarray(f[k])
                finite = finite and bool(np.isfinite(a).all())
                h.update(a.tobytes())
    return finite, h.hexdigest()


def collect(ctx, run):
    """Every sweep of the window read back: one with a map that is not
    finite counts as failed; the others' digests are kept."""
    from ..harness import note
    t0 = time.perf_counter()
    sound = []
    for u in run.units:
        finite, digest = read_back(u.pop("rows"))
        if finite:
            sound.append(u)
            ctx.digests.append(digest)
        else:
            run.failed += 1
    note(f"{len(run.units)} sweeps read back in "
         f"{time.perf_counter() - t0:.3f} s, {len(sound)} finite")
    run.units[:] = sound


def map_run(sw, freq_hz):
    """The map settings of the sweep's map at freq_hz."""
    p = sweep_preset(freq_hz, sw["exact_presets"])
    return dict(n_pix=sw["n_pix"], x_fov=float(p["x_fov"]),
                freq_hz=float(freq_hz), grid_n=int(p["grid_n"]),
                grid_extent=float(p["grid_extent"]),
                z_observer=float(p["z_observer"]), dt=float(p["dt"]),
                n_steps=int(p["n_steps"]),
                record_stride=int(p["record_stride"]),
                s_input_on=sw["s_input_on"], nfreq=1, freq0=float(freq_hz),
                freq_log_step=0.0, phi0_offset=sw["phi0_offset"],
                **sw["map"])


def answers(ctx):
    """{map index: (T_b, V/I)} of the last sweep's sampled maps at the
    sampled pixels, read back from their .npz files."""
    out = {}
    for i in ctx.maps:
        with np.load(ctx.rows[i]["npz"]) as f:
            out[i] = (f["emission_cube"].reshape(-1, 1)[ctx.pixels],
                      f["emission_polVI_cube"].reshape(-1, 1)[ctx.pixels])
    return out


def reference(ctx, dtype=torch.float32):
    """{map index: (T_b, V/I)} of the plain reference at the sampled maps
    and pixels, each map at the preset worked out for its frequency."""
    from ..harness import note
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for i in ctx.maps:
        t0 = time.perf_counter()
        out[i] = map_pixels(ctx.arrays, ctx.mesh,
                            map_run(ctx.sw, ctx.freqs[i]), ctx.pixels,
                            ctx.device, dtype)
        note(f"reference: map {i} ({ctx.freqs[i] / 1e6:.3f} MHz), "
             f"{len(ctx.pixels)} pixels in {time.perf_counter() - t0:.3f} s")
    return out


def gaps(got, want):
    """The largest gaps over the sampled maps."""
    each = [map_gaps(got[i][0], want[i][0], got[i][1], want[i][1])
            for i in want]
    return {k: max(g[k] for g in each) for k in ("tb_gap", "vi_gap")}


def check(ctx, run):
    """{number: (value, limit)}: sweeps whose maps differ from the last
    sweep's, and the last sweep's sampled maps at the sampled pixels
    against the plain reference's."""
    last = ctx.digests[-1] if ctx.digests else None
    differing = sum(d != last for d in ctx.digests)
    lim = limits(run.cell)
    got = answers(ctx)
    want = ctx.want = reference(ctx)
    return {"sweeps_differing": (differing, 0),
            **{k: (v, lim[k]) for k, v in gaps(got, want).items()}}
