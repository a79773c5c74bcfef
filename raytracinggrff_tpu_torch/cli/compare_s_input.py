"""Compare emission maps with vs without the cross-section S input, on
PyTorch/CUDA.

Capability-parity with script/compare_s_input.py and the JAX package's
rgrff-compare-s-input: two pipeline runs (+/- s_input_on),
difference/ratio statistics, 3-panel comparison plot, --skip-run resume
from existing npz artifacts. The reference shells out to a subprocess per
run (compare_s_input.py:24-38); here both runs share one scene resampled
on --device (default cuda), and the beam runs there too.

    python -m raytracinggrff_tpu_torch.cli.compare_s_input -m ./corona
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..pipeline import RayEmissionConfig, run_ray_tracing_emission


def load_map(npz_path, key="emission_cube"):
    data = np.load(npz_path)
    cube = data[key]
    return cube[:, :, 0] if cube.ndim == 3 else cube


def build_parser():
    p = argparse.ArgumentParser(
        description="Compare T_b map with vs without S input.")
    p.add_argument("--model-path", "-m", type=str, default="./corona")
    p.add_argument("--N-pix", "-n", type=int, default=100)
    p.add_argument("--X-FOV", "-f", type=float, default=2.25)
    p.add_argument("--freq", type=float, default=60e6)
    p.add_argument("--grid-n", type=int, default=150)
    p.add_argument("--grid-extent", type=float, default=3.0)
    p.add_argument("--dt", type=float, default=6e-3)
    p.add_argument("--n-steps", type=int, default=5000)
    p.add_argument("--record-stride", type=int, default=10)
    p.add_argument("--phi0-offset", type=float, default=0.0)
    p.add_argument("--consider-beam", action="store_true")
    p.add_argument("--beam-fwhm", type=float, default=0.1)
    p.add_argument("--baseline-m", type=float, default=None,
                   help="Derive the beam from an interferometer baseline: "
                        "theta = lambda/baseline, FWHM expressed in R_sun "
                        "at 1 AU (ref: compare_on_off_scaling_factor.py)")
    p.add_argument("--skip-run", action="store_true",
                   help="Only load existing npz and compare/plot")
    p.add_argument("--out-dir", "-o", type=str, default=".")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--quiet", "-q", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of both runs (default: cuda)")
    # compat no-ops
    p.add_argument("--raytrace-device", default="cuda")
    p.add_argument("--grff-backend", default="native")
    p.add_argument("--no-fallback", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.baseline_m is not None:
        from ..constants import AU_CM, R_SUN_CM, C_CGS
        lam_cm = C_CGS / args.freq
        theta_rad = lam_cm / (args.baseline_m * 100.0)
        args.beam_fwhm = theta_rad * AU_CM / R_SUN_CM
        args.consider_beam = True
        print(f"Baseline {args.baseline_m} m -> beam FWHM "
              f"{args.beam_fwhm:.3f} R_sun at {args.freq/1e6:.1f} MHz")
    out_dir = Path(args.out_dir).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    path_on = out_dir / "ray_tracing_compare_s_on.npz"
    path_off = out_dir / "ray_tracing_compare_s_off.npz"

    if not args.skip_run:
        from ..grids import UniformGrid
        from ..mas.model import MASModel
        from ..pipeline import prepare_cubes
        grid = UniformGrid.cube(args.grid_extent, args.grid_n)
        cubes = prepare_cubes(MASModel(args.model_path), grid,
                              args.phi0_offset, verbose=not args.quiet,
                              device=args.device)
        common = dict(n_pix=args.N_pix, x_fov=args.X_FOV, freq_hz=args.freq,
                      grid_n=args.grid_n, grid_extent=args.grid_extent,
                      dt=args.dt, n_steps=args.n_steps,
                      record_stride=args.record_stride,
                      phi0_offset=args.phi0_offset)
        for s_on, path in ((True, path_on), (False, path_off)):
            if not args.quiet:
                print(f"Run with s_input_on={s_on} ...")
            run_ray_tracing_emission(
                cubes=cubes, config=RayEmissionConfig(s_input_on=s_on,
                                                      **common),
                out_path=path, verbose=not args.quiet, device=args.device)
    elif not (path_on.is_file() and path_off.is_file()):
        print("--skip-run set but missing npz files.", file=sys.stderr)
        sys.exit(1)

    t_on = load_map(path_on)
    t_off = load_map(path_off)
    if args.consider_beam:
        # beam-smoothed comparison (ref: compare_on_off_scaling_factor.py)
        from ..utils.beam import gaussian_beam_convolve
        sigma_pix = args.beam_fwhm / (2 * args.X_FOV) * args.N_pix
        t_on = gaussian_beam_convolve(t_on, sigma_pix,
                                      device=args.device).cpu().numpy()
        t_off = gaussian_beam_convolve(t_off, sigma_pix,
                                       device=args.device).cpu().numpy()
    valid = (np.isfinite(t_on) & np.isfinite(t_off)
             & (t_on > 0) & (t_off > 0))
    diff = t_on - t_off
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(t_off > 0, t_on / t_off, np.nan)

    print("\n--- T_b with S input ---")
    print(f"  min={np.nanmin(t_on):.4e}, max={np.nanmax(t_on):.4e}, "
          f"mean(valid)={np.nanmean(t_on[valid]):.4e} K")
    print("--- T_b without S input ---")
    print(f"  min={np.nanmin(t_off):.4e}, max={np.nanmax(t_off):.4e}, "
          f"mean(valid)={np.nanmean(t_off[valid]):.4e} K")
    print("--- Difference (S_on - S_off) ---")
    print(f"  mean(diff)={np.nanmean(diff[valid]):.4e}, "
          f"mean(|diff|)={np.nanmean(np.abs(diff[valid])):.4e}, "
          f"max|diff|={np.nanmax(np.abs(diff[valid])):.4e} K")
    r_valid = ratio[valid]
    print("--- Ratio (S_on / S_off) on valid pixels ---")
    print(f"  min={np.nanmin(r_valid):.4f}, max={np.nanmax(r_valid):.4f}, "
          f"mean={np.nanmean(r_valid):.4f}")

    if not args.no_plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        extent = [-args.X_FOV, args.X_FOV, -args.X_FOV, args.X_FOV]
        panels = [(axes[0], t_on, "$T_b$ with S (--s-input-on)"),
                  (axes[1], t_off, "$T_b$ without S"),
                  (axes[2], diff, "Difference (S_on $-$ S_off)")]
        for ax, arr, title in panels:
            a = arr.copy()
            if "Difference" in title:
                a[~valid] = np.nan
                v = max(np.nanmax(np.abs(a)), 1e-10)
                im = ax.imshow(a, origin="lower", extent=extent,
                               aspect="equal", cmap="RdBu_r", vmin=-v,
                               vmax=v, interpolation="bilinear")
            else:
                a[a <= 0] = np.nan
                im = ax.imshow(a, origin="lower", extent=extent,
                               aspect="equal", cmap="hot",
                               interpolation="bilinear")
            ax.set_xlabel("x (R_sun)")
            ax.set_ylabel("y (R_sun)")
            ax.set_title(title)
            plt.colorbar(im, ax=ax)
        plt.tight_layout()
        plot_path = out_dir / "compare_s_input.png"
        plt.savefig(plot_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        print(f"\nComparison plot saved to {plot_path}")


if __name__ == "__main__":
    main()
