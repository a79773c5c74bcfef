"""Multi-frequency T_b spectral sweep (30-800 MHz) on PyTorch/CUDA.

Capability-parity with script/pub/TbSpectra_gen.py and the JAX package's
rgrff-tb-spectra: per-band automatic parameter presets (low-band
(f_ref/f)^0.5 scaling of dt/n_steps/stride, high-band log-frequency
anchor interpolation), snapped by default onto the JAX sweep's lattice
(quantize_params) so that both packages trace the same presets,
resumable --start-from-idx, per-frequency npz + png outputs and a
manifest file. The scene cubes are resampled on the device once per
distinct (grid_n, grid_extent) preset, and only one cube set is resident
at a time.

    python -m raytracinggrff_tpu_torch.cli.tb_spectra -m ./corona

run_sweep does the device work and writes the npz files; main adds the
pngs (matplotlib, imported only there) and the manifest.
"""

from __future__ import annotations

import argparse
import contextlib
from pathlib import Path

import numpy as np
import torch

from ..grids import UniformGrid
from ..mas.model import MASModel
from ..pipeline import (RayEmissionConfig, prepare_cubes,
                        run_ray_tracing_emission)
from ..utils import profiling


def _lowband_params(freq_hz):
    """Low-band scaling (ref: TbSpectra_gen.py:27-44 /
    compare_LOS_raytracing.py:35-63): dt and stride scale with
    (100 MHz / f)^0.5, n_steps inversely, floor 1200."""
    ref_freq_hz = 100e6
    scale = (ref_freq_hz / freq_hz) ** 0.5
    return {
        "grid_n": 256, "grid_extent": 4.0, "z_observer": 4.0, "x_fov": 2.8,
        "dt": 6e-3 * scale,
        "n_steps": max(1200, int(round(4000 / max(scale, 1e-12)))),
        "record_stride": max(1, int(round(5 * scale))),
    }


_HIGHBAND_ANCHORS = {
    280e6: {"grid_n": 400, "grid_extent": 1.75, "z_observer": 1.75,
            "x_fov": 1.44, "dt": 1.0e-3, "n_steps": 4500,
            "record_stride": 10},
    550e6: {"grid_n": 440, "grid_extent": 1.45, "z_observer": 1.45,
            "x_fov": 1.44, "dt": 0.8e-3, "n_steps": 7500,
            "record_stride": 5},
    800e6: {"grid_n": 520, "grid_extent": 1.45, "z_observer": 1.44,
            "x_fov": 1.44, "dt": 0.4e-3, "n_steps": 12000,
            "record_stride": 5},
}


def _interp_log_freq_params(freq_hz, f0, p0, f1, p1):
    t = (np.log(freq_hz) - np.log(f0)) / (np.log(f1) - np.log(f0))
    t = float(np.clip(t, 0.0, 1.0))
    return {k: (1.0 - t) * p0[k] + t * p1[k] for k in p0}


def _highband_params(freq_hz):
    """High-band anchor interpolation in log f
    (ref: TbSpectra_gen.py:56-70 /
    compare_LOS_raytracing_highband.py:205-221)."""
    a = _HIGHBAND_ANCHORS
    if freq_hz <= 550e6:
        p = _interp_log_freq_params(freq_hz, 280e6, a[280e6], 550e6, a[550e6])
    else:
        p = _interp_log_freq_params(freq_hz, 550e6, a[550e6], 800e6, a[800e6])
    for k in ("grid_n", "n_steps", "record_stride"):
        p[k] = int(round(p[k]))
    return p


def select_params(freq_hz):
    """Frequency-dependent tracer presets (ref: TbSpectra_gen.py:73-88)."""
    if freq_hz <= 150e6:
        return _lowband_params(freq_hz)
    if freq_hz >= 280e6:
        return _highband_params(freq_hz)
    p = _interp_log_freq_params(freq_hz, 150e6, _lowband_params(150e6),
                                280e6, _highband_params(280e6))
    for k in ("grid_n", "n_steps", "record_stride"):
        p[k] = int(round(p[k]))
    return p


def quantize_params(p, seg_records=25):
    """Snap a preset onto the JAX sweep's lattice (raytracinggrff_tpu/cli/
    tb_spectra.py:84-133), so that the port runs the JAX sweep's presets.
    Every adjustment only ever grants more resolution, steps or records
    than the preset asked for:

    * grid_extent rounds up to a multiple of 0.25 R_sun (fewer distinct
      cube sets to resample).
    * grid_n rounds up to a multiple of 128, or to 576, and far enough to
      keep the cell size dx = 2*extent/grid_n at or below the preset's.
    * record_stride rounds down to a power of two (more records).
    * n_steps rounds up to a whole number of seg_records x record_stride
      steps. Extra steps land after rays have left the cube and record
      frozen no-op rows.

    Disable with --exact-presets for strict reference-preset parity.
    """
    q = dict(p)
    ext = float(p["grid_extent"])
    dx_preset = 2.0 * ext / int(p["grid_n"])
    ext_q = float(np.ceil(ext / 0.25) * 0.25)
    q["grid_extent"] = ext_q
    n_min = int(np.ceil(2.0 * ext_q / dx_preset))
    q["grid_n"] = next(n for n in sorted(
        [128 * k for k in range(1, 33)] + [576]) if n >= n_min)
    stride = int(p["record_stride"])
    q["record_stride"] = stride = max(1, 2 ** int(np.log2(stride)))
    n_rec = -(-int(p["n_steps"]) // stride)
    n_rec = -(-n_rec // seg_records) * seg_records
    q["n_steps"] = n_rec * stride
    return q


def sweep_frequencies(fmin_mhz=30.0, fmax_mhz=800.0, n_freq=30):
    """The sweep's log-spaced frequencies in Hz."""
    return np.logspace(np.log10(fmin_mhz), np.log10(fmax_mhz), n_freq) * 1e6


def run_sweep(model_path, freqs_hz, out_dir, n_pix=128, phi0_offset=-140.0,
              s_input_on=False, exact_presets=False, start_from_idx=0,
              device="cuda", timings=None, plot_only=False, verbose=True):
    """Run the maps of freqs_hz[start_from_idx:] on `device` and write
    their npz files into out_dir (plot_only: only check that they exist).
    Returns the manifest rows {idx, freq_hz, npz, png}: those of the run,
    preceded by the rows below start_from_idx whose npz and png both
    exist, so that a resumed sweep keeps a complete manifest.

    The cube set of a (grid_n, grid_extent) preset is resampled once and
    dropped before the next one is made: presets are monotone in
    frequency, so each group is contiguous, and high-band cube sets
    (576^3 x 4 cubes) must not pile up in device memory. A list passed
    as `timings` makes each map record its spans (utils/profiling: one
    recording a map, holding the cube-set resample that the map triggers
    and, nested in it, run_ray_tracing_emission's) and receives one dict
    per map run: the preset, the number of records, the map's `timings`
    of run_ray_tracing_emission (seconds per span: resample, with its
    cube set's resample, "read" and "upload" when the map made it; rays,
    trace, trace_inputs, transfer, finish, write; segments) and, on a
    CUDA device, the peak device memory allocated while the map ran
    (bytes)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if start_from_idx < 0 or start_from_idx >= len(freqs_hz):
        raise ValueError(
            f"--start-from-idx must be in [0, {len(freqs_hz) - 1}]")
    cuda = torch.device(device).type == "cuda"
    rows = []
    cube_key, cubes = None, None
    with profiling.span("sweep", clock=None):
        for i, freq_hz in enumerate(freqs_hz):
            tag = f"{i:02d}_{freq_hz / 1e6:08.3f}MHz"
            npz_path = out_dir / f"raytrace_{tag}.npz"
            png_path = out_dir / f"Tb_map_{tag}.png"
            row = {"idx": i, "freq_hz": float(freq_hz), "npz": str(npz_path),
                   "png": str(png_path)}
            if i < start_from_idx:
                if npz_path.exists() and png_path.exists():
                    rows.append(row)
                continue
            p = select_params(float(freq_hz))
            if not exact_presets:
                p = quantize_params(p)
            if not plot_only:
                if verbose:
                    print(f"[{i + 1:02d}/{len(freqs_hz)}] "
                          f"{freq_hz / 1e6:8.3f} MHz | grid_n={p['grid_n']} "
                          f"dt={p['dt']:.3g} n_steps={p['n_steps']} "
                          f"stride={p['record_stride']}")
                if cuda:
                    torch.cuda.reset_peak_memory_stats(device)
                stages = None if timings is None else {}
                recorder = (contextlib.nullcontext() if timings is None
                            else profiling.recording(device))
                with recorder as rec:
                    key = (p["grid_n"], round(p["grid_extent"], 6))
                    if key != cube_key:
                        with profiling.span("resample", "device"):
                            cubes = None  # free the previous set first
                            grid = UniformGrid.cube(p["grid_extent"],
                                                    p["grid_n"])
                            cubes = prepare_cubes(
                                MASModel(model_path), grid, phi0_offset,
                                verbose=verbose, device=device)
                        cube_key = key
                    cfg = RayEmissionConfig(
                        n_pix=n_pix, x_fov=float(p["x_fov"]),
                        freq_hz=float(freq_hz), grid_n=int(p["grid_n"]),
                        grid_extent=float(p["grid_extent"]),
                        z_observer=float(p["z_observer"]), dt=float(p["dt"]),
                        n_steps=int(p["n_steps"]),
                        record_stride=int(p["record_stride"]),
                        s_input_on=s_input_on, nfreq=1, freq0=float(freq_hz),
                        phi0_offset=phi0_offset)
                    run_ray_tracing_emission(
                        cubes=cubes, config=cfg, out_path=str(npz_path),
                        verbose=verbose, device=device, timings=stages)
                if timings is not None:
                    stages.update(rec.totals())  # and the cube set's spans
                    timings.append(dict(
                        idx=i, freq_hz=float(freq_hz), **p,
                        records=-(-cfg.n_steps // cfg.record_stride),
                        **stages,
                        peak_bytes=(torch.cuda.max_memory_allocated(device)
                                    if cuda else None)))
            if not npz_path.exists():
                raise FileNotFoundError(
                    f"Missing expected npz file: {npz_path}")
            rows.append(row)
    return rows


def save_map_png(tb_map, x_coords_m, y_coords_m, freq_hz, out_png):
    """One sweep frame: T_b map with a dotted photosphere circle."""
    from ..constants import R_SUN_M
    from ..utils.plotting import _plt

    plt = _plt()
    tb = np.where(np.isfinite(tb_map), np.asarray(tb_map, float), 0.0)
    xr = np.asarray(x_coords_m[[0, -1]]) / R_SUN_M
    yr = np.asarray(y_coords_m[[0, -1]]) / R_SUN_M
    top = max(float(tb.max(initial=0.0)), 1.0)

    fig, ax = plt.subplots(figsize=(6, 4.8))
    im = ax.imshow(tb, origin="lower", cmap="hot", aspect="equal",
                   extent=[xr[0], xr[1], yr[0], yr[1]], vmin=0.0, vmax=top)
    theta = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(theta), np.sin(theta), ":", color="w", linewidth=1.0)
    ax.set(xlabel=r"x ($R_\odot$)", ylabel=r"y ($R_\odot$)",
           title=f"Ray tracing $T_b$ at {freq_hz / 1e6:.3f} MHz")
    fig.colorbar(im, ax=ax, label="T_b (K)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=150, bbox_inches="tight")
    plt.close(fig)


def build_parser():
    p = argparse.ArgumentParser(
        description="Generate ray-tracing T_b spectra maps (30-800 MHz).")
    p.add_argument("--model-path", "-m", default="./corona")
    p.add_argument("--out-dir", default="mfs")
    p.add_argument("--N-pix", "-n", type=int, default=128)
    p.add_argument("--fmin-mhz", type=float, default=30.0)
    p.add_argument("--fmax-mhz", type=float, default=800.0)
    p.add_argument("--n-freq", type=int, default=30)
    p.add_argument("--start-from-idx", type=int, default=0,
                   help="Resume the sweep from this index (inclusive)")
    p.add_argument("--phi0-offset", type=float, default=-140.0)
    p.add_argument("--s-input-on", action="store_true")
    p.add_argument("--plot-only", action="store_true",
                   help="Only regenerate pngs from existing npz files")
    p.add_argument("--exact-presets", action="store_true",
                   help="Use the reference's exact per-frequency presets "
                        "instead of the JAX sweep's lattice (see "
                        "quantize_params)")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the sweep (default: cuda)")
    # compat no-ops
    p.add_argument("--raytrace-device", default="cuda")
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--no-fallback", action="store_true")
    p.add_argument("--grff-lib", default=None)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    out_dir = Path(args.out_dir)
    freqs_hz = sweep_frequencies(args.fmin_mhz, args.fmax_mhz, args.n_freq)
    rows = run_sweep(args.model_path, freqs_hz, out_dir, n_pix=args.N_pix,
                     phi0_offset=args.phi0_offset,
                     s_input_on=args.s_input_on,
                     exact_presets=args.exact_presets,
                     start_from_idx=args.start_from_idx, device=args.device,
                     plot_only=args.plot_only, verbose=not args.quiet)
    for row in rows:
        if row["idx"] < args.start_from_idx:
            continue
        data = np.load(row["npz"])
        save_map_png(data["emission_cube"][:, :, 0], data["x_coords"],
                     data["y_coords"], row["freq_hz"], row["png"])

    # manifest of completed outputs: the sweep's resume/bookkeeping record
    manifest = out_dir / "TbSpectra_manifest.txt"
    lines = ["# idx freq_hz npz_path png_path"]
    lines += ["{idx:02d} {freq_hz:.6e} {npz} {png}".format(**r)
              for r in rows]
    manifest.write_text("\n".join(lines) + "\n", encoding="utf-8")
    print(f"Saved {len(rows)} maps to {out_dir} (manifest: {manifest})")


if __name__ == "__main__":
    main()
