"""Straight-LOS resampling CLI on a torch device
(script/resampling_MAS_LOS.py:386-428); the flags of the JAX package's
rgrff-resample-los plus --device (default cuda).

    python -m raytracinggrff_tpu_torch.cli.resample_los -m ./corona
"""

from __future__ import annotations

import argparse

from ..pipeline import resample_mas_los


def _parse_range(s):
    parts = s.split(",")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(
            f"Range must be 'min,max' (e.g. -1.5,1.5), got {s}")
    return [float(p.strip()) for p in parts]


def build_parser():
    p = argparse.ArgumentParser(
        description="Resample MAS model along line-of-sight for emission "
                    "calculation.")
    p.add_argument("--model-path", "-m", type=str, default="./corona")
    p.add_argument("--N-pix", "-n", type=int, default=128)
    p.add_argument("--X-FOV", "-f", type=float, default=1.44)
    p.add_argument("--N-z", "-z", type=int, default=400)
    p.add_argument("--dz0", "-d", type=float, default=3e-4)
    p.add_argument("--no-variable-spacing-z", "-v", action="store_true")
    p.add_argument("--z-range", "-zr", type=_parse_range, default=None)
    p.add_argument("--out-path", "-o", type=str, default="LOS_data.npz")
    p.add_argument("--phi0-offset", type=float, default=24.0,
                   help="Longitude offset in degrees (default: 24)")
    p.add_argument("--no-plots", "-p", action="store_true")
    p.add_argument("--timestep", type=int, default=0,
                   help="Timestep index for multi-timestep model dirs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the sampling (default: cuda)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    fov = args.X_FOV
    result = resample_mas_los(
        model_path=args.model_path, n_pix=args.N_pix,
        x_range=(-fov, fov), y_range=(-fov, fov), n_z=args.N_z,
        dz0=args.dz0, variable_spacing_z=not args.no_variable_spacing_z,
        z_range=args.z_range, phi0_offset=args.phi0_offset,
        out_path=args.out_path, verbose=not args.quiet,
        timestep=args.timestep, device=args.device)
    if not args.no_plots:
        _save_los_plots(result, args.N_pix, fov, verbose=not args.quiet)
    return 0


def _save_los_plots(result, n_pix, fov, verbose=True):
    """LOS profile and slice plots (resampling_MAS_LOS.py:312-371)."""
    import numpy as np
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from ..constants import R_SUN_M

    Ne, Te = result["Ne_LOS"], result["Te_LOS"]
    z = result["z_coords"] / R_SUN_M
    test_pixels = [(n_pix // 2, n_pix // 2), (n_pix // 4, n_pix // 4),
                   (3 * n_pix // 4, 3 * n_pix // 4)]
    fig, axes = plt.subplots(2, len(test_pixels), figsize=(15, 8))
    for idx, (i, j) in enumerate(test_pixels):
        axes[0, idx].plot(z, Ne[i, j, :], "b-")
        axes[0, idx].set_yscale("log")
        axes[0, idx].set_title(f"Pixel ({i},{j}) N_e along LOS")
        axes[1, idx].plot(z, Te[i, j, :], "r-")
        axes[1, idx].set_yscale("log")
        axes[1, idx].set_title("T_e along LOS")
    plt.tight_layout()
    plt.savefig("LOS_test_profiles.png", dpi=150, bbox_inches="tight")
    plt.close(fig)

    fig2, axes2 = plt.subplots(1, 3, figsize=(18, 5))
    ext = [-fov, fov, -fov, fov]
    for ax, cube, name, cmap in ((axes2[0], Ne, "N_e", "viridis"),
                                 (axes2[1], Te, "T_e", "plasma"),
                                 (axes2[2], result["B_LOS"], "|B|", "hot")):
        with np.errstate(divide="ignore", invalid="ignore"):
            im = ax.imshow(np.log10(cube[:, :, 1]), origin="lower",
                           extent=ext, aspect="equal", cmap=cmap)
        ax.set_title(f"{name} at z index 1")
        plt.colorbar(im, ax=ax)
    plt.tight_layout()
    plt.savefig("LOS_2D_slices.png", dpi=150, bbox_inches="tight")
    plt.close(fig2)
    if verbose:
        print("Test plots saved to LOS_test_profiles.png and "
              "LOS_2D_slices.png")


if __name__ == "__main__":
    main()
