"""Straight-LOS vs refractive ray-tracing comparison on a torch device
(script/pub/compare_LOS_raytracing.py and its high-band twin): both
pipelines at N frequencies with frequency-scaled parameters, a 2x3
comparison figure, and --plot-only to redraw from existing .npz files.
The plot-stage beam is beam_size = beam_factor / freq
(compare_LOS_raytracing.py:66-87). The flags of the JAX package's
rgrff-compare-los-raytracing plus --device (default cuda).

    python -m raytracinggrff_tpu_torch.cli.compare_los_raytracing -m ./corona
"""

from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import numpy as np

from ..constants import R_SUN_M
from ..pipeline import (RayEmissionConfig, resample_mas_los,
                        run_ray_tracing_emission, synthetic_ff)
from ..utils import profiling


def frequency_scaled_params(freq_hz, ref_freq_hz=100e6, base_dt=6e-3,
                            base_n_steps=4000, base_record_stride=5,
                            base_dz0=3e-4, base_nz=400, scaling_exp=0.5,
                            min_n_steps=1200, min_nz=200):
    """Lower frequency -> larger steps, fewer samples
    (compare_LOS_raytracing.py:35-63)."""
    scale = (ref_freq_hz / freq_hz) ** scaling_exp
    return {
        "dt": base_dt * scale,
        "n_steps": max(min_n_steps,
                       int(round(base_n_steps / max(scale, 1e-12)))),
        "record_stride": max(1, int(round(base_record_stride * scale))),
        "dz0": base_dz0 * scale,
        "n_z": max(min_nz, int(round(base_nz / max(scale, 1e-12)))),
    }


HIGHBAND_PRESETS = {
    280e6: dict(grid_n=400, grid_extent=1.75, z_observer=1.75, dt=1.0e-3,
                n_steps=4500, record_stride=10, dz0=1.2e-4, n_z=900),
    550e6: dict(grid_n=440, grid_extent=1.45, z_observer=1.45, dt=0.8e-3,
                n_steps=7500, record_stride=5, dz0=1.0e-4, n_z=1000),
    800e6: dict(grid_n=520, grid_extent=1.45, z_observer=1.44, dt=0.4e-3,
                n_steps=12000, record_stride=5, dz0=0.9e-4, n_z=1100),
}
# the keys of a preset that compare_frequency takes, and the one it may
# add: the trace's records a segment (RayEmissionConfig's default
# otherwise), which changes no record
PRESET_KEYS = frozenset(HIGHBAND_PRESETS[800e6])
PRESET_OPTIONAL = frozenset({"seg_records"})


def apply_plot_beam(map_in, freq_hz, beam_factor, x_coords_m, y_coords_m,
                    device="cuda"):
    """Gaussian plot-stage beam, beam_size_Rsun = beam_factor / freq."""
    from ..utils.beam import gaussian_beam_convolve
    out = np.array(map_in, dtype=float, copy=True)
    beam_rsun = beam_factor / freq_hz
    if beam_rsun <= 0 or len(x_coords_m) < 2:
        return out
    dx = abs((x_coords_m[1] - x_coords_m[0]) / R_SUN_M)
    dy = abs((y_coords_m[1] - y_coords_m[0]) / R_SUN_M)
    pix = 0.5 * (dx + dy)
    if pix <= 0:
        return out
    return gaussian_beam_convolve(np.nan_to_num(out), beam_rsun / pix,
                                  device=device).cpu().numpy()


def plot_compare_2x3(ray_maps, los_maps, freqs_hz, x_coords_m, y_coords_m,
                     out_png, plot_consider_beam=False, beam_factor=5e6,
                     device="cuda"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(9.9, 6.6),
                             constrained_layout=True)
    extent = [x_coords_m[0] / R_SUN_M, x_coords_m[-1] / R_SUN_M,
              y_coords_m[0] / R_SUN_M, y_coords_m[-1] / R_SUN_M]
    labels = [["(a1)", "(a2)", "(a3)"], ["(b1)", "(b2)", "(b3)"]]
    for col, freq in enumerate(freqs_hz[:3]):
        for row, maps in ((0, ray_maps), (1, los_maps)):
            m = np.array(maps[col], float)
            if plot_consider_beam:
                m = apply_plot_beam(m, freq, beam_factor, x_coords_m,
                                    y_coords_m, device=device)
            m[m <= 0] = np.nan
            ax = axes[row, col]
            im = ax.imshow(m, origin="lower", extent=extent, aspect="equal",
                           cmap="hot", interpolation="bilinear")
            ax.add_patch(plt.Circle((0, 0), 1.0, edgecolor="white",
                                    facecolor="none", linewidth=1.0,
                                    linestyle=":"))
            ax.set_title(f"{labels[row][col]} "
                         f"{'Raytrace' if row == 0 else 'LOS'} "
                         f"{freq/1e6:.0f} MHz", fontsize=9)
            plt.colorbar(im, ax=ax, label="T_b (K)")
    fig.savefig(out_png, dpi=160, bbox_inches="tight")
    plt.close(fig)


def compare_frequency(model_path, freq, n_pix=128, x_fov=2.8, grid_n=256,
                      grid_extent=4.0, z_observer=4.0, phi0_offset=0.0,
                      highband=False, ray_npz=None, los_npz=None,
                      verbose=True, device="cuda", timings=None,
                      preset=None):
    """Both maps at one frequency: the ray-traced map at the
    frequency-scaled parameters on the grid_n^3 cube of grid_extent with
    the observer at z_observer (or the high-band preset) and the
    straight-LOS map at the matching n_z and dz0. `preset`, a dict of
    PRESET_KEYS (and optionally PRESET_OPTIONAL), is used in place of
    either. Returns (ray result, LOS emission result); the .npz paths are
    written when given.

    A dict passed as `timings` makes the call record both maps in one
    recording (utils/profiling.recording) and receives the seconds of
    their spans, summed by name: "ray" and "los" around each map on the
    host clock, the LOS chain's spans (resample_mas_los's and
    synthetic_ff's, each named "los_..."), while torch.profiler records
    the LOS chain's counts, and the ray-traced map's own timings
    (run_ray_tracing_emission's), as a map alone gives them."""
    if preset is not None:
        p = dict(preset)
        if not PRESET_KEYS <= set(p) <= PRESET_KEYS | PRESET_OPTIONAL:
            raise ValueError(
                f"a preset holds {sorted(PRESET_KEYS)} and may hold "
                f"{sorted(PRESET_OPTIONAL)}; this one lacks "
                f"{sorted(PRESET_KEYS - set(p))} and adds "
                f"{sorted(set(p) - PRESET_KEYS - PRESET_OPTIONAL)}")
    elif highband:
        p = dict(HIGHBAND_PRESETS[freq])
    else:
        p = dict(frequency_scaled_params(freq), grid_n=grid_n,
                 grid_extent=grid_extent, z_observer=z_observer)
    dz0, n_z = p.pop("dz0"), p.pop("n_z")
    cfg = RayEmissionConfig(n_pix=n_pix, x_fov=x_fov, freq_hz=freq,
                            phi0_offset=phi0_offset, **p)
    recorder = (profiling.recording(device) if timings is not None
                else contextlib.nullcontext())
    ray_timings = {} if timings is not None else None
    with recorder as rec:
        with profiling.span("ray"):
            ray = run_ray_tracing_emission(
                model_path=model_path, config=cfg, out_path=ray_npz,
                verbose=verbose, device=device, timings=ray_timings)
        with profiling.span("los"):
            los = resample_mas_los(
                model_path, n_pix=n_pix, x_range=(-x_fov, x_fov),
                y_range=(-x_fov, x_fov), n_z=n_z, dz0=dz0,
                phi0_offset=phi0_offset, verbose=verbose, device=device)
            emission = synthetic_ff(los, freq, 1, 0.0, out_path=los_npz,
                                    verbose=verbose, device=device)
    if rec is not None:
        timings.update(rec.totals(), **rec.counters())
        timings.update(ray_timings)
    return ray, emission


def build_parser():
    p = argparse.ArgumentParser(
        description="Compare straight-LOS vs ray-tracing T_b maps.")
    p.add_argument("--model-path", "-m", default="./corona")
    p.add_argument("--N-pix", "-n", type=int, default=128)
    p.add_argument("--freqs-mhz", type=float, nargs="+",
                   default=[30.0, 60.0, 120.0])
    p.add_argument("--highband", action="store_true",
                   help="Use the high-band presets (280/550/800 MHz)")
    p.add_argument("--X-FOV", "-f", type=float, default=2.8)
    p.add_argument("--grid-n", type=int, default=256)
    p.add_argument("--grid-extent", type=float, default=4.0)
    p.add_argument("--z-observer", type=float, default=4.0)
    p.add_argument("--phi0-offset", type=float, default=0.0)
    p.add_argument("--out-dir", "-o", default="compare_los_raytracing")
    p.add_argument("--plot-only", action="store_true")
    p.add_argument("--plot-consider-beam", action="store_true")
    p.add_argument("--beam-factor", type=float, default=5e6)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of both pipelines (default: cuda)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.highband:
        freqs_hz = sorted(HIGHBAND_PRESETS)
    else:
        freqs_hz = [f * 1e6 for f in args.freqs_mhz]

    ray_maps, los_maps = [], []
    for freq in freqs_hz:
        tag = f"{freq/1e6:.0f}MHz"
        ray_npz = out_dir / f"ray_{tag}.npz"
        los_npz = out_dir / f"los_{tag}.npz"
        if args.plot_only:
            ray = np.load(ray_npz)
            los = np.load(los_npz)
        else:
            ray, los = compare_frequency(
                args.model_path, freq, n_pix=args.N_pix, x_fov=args.X_FOV,
                grid_n=args.grid_n, grid_extent=args.grid_extent,
                z_observer=args.z_observer, phi0_offset=args.phi0_offset,
                highband=args.highband, ray_npz=ray_npz, los_npz=los_npz,
                verbose=not args.quiet, device=args.device)
        ray_maps.append(ray["emission_cube"][:, :, 0])
        los_maps.append(los["emission_cube"][:, :, 0])
        x_m, y_m = ray["x_coords"], ray["y_coords"]

    out_png = out_dir / "compare_LOS_raytracing.png"
    plot_compare_2x3(ray_maps, los_maps, freqs_hz, x_m, y_m, out_png,
                     args.plot_consider_beam, args.beam_factor,
                     device=args.device)
    print(f"Saved {out_png}")


if __name__ == "__main__":
    main()
