"""ROI T_b spectra: observed multi-band images vs a model frequency sweep.

Capability-parity with the reference's publication workflow
(script/pub/compare_ovro_Tb_spec.py): collect the per-frequency model maps
produced by the tb_spectra sweep, average them in rectangular ROIs, do the
same for every band of a multi-band observation (FITS with a cfreqs
bintable, HDF5, or npz — utils/obs.py), and overlay the two spectra per
ROI with 3-sigma image-corner noise bars on the observed points.

The port's copy of raytracinggrff_tpu/cli/obs_spectrum.py, on the port's
utils/obs.py (numpy and matplotlib; no device work):

    python -m raytracinggrff_tpu_torch.cli.obs_spectrum -m mfs -b obs.fits
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from ..constants import R_SUN_M
from ..utils.obs import load_multiband_observation

# Reference ROIs (R_sun, publication figure: compare_ovro_Tb_spec.py:27-28)
DEFAULT_ROIS = [("ROI-1", -0.15, 0.15, 0.7, 1.0),
                ("ROI-2", 0.0, 0.3, -0.2, 0.1)]


def _rect_mean(img, x, y, x0, x1, y0, y1):
    X, Y = np.meshgrid(np.asarray(x), np.asarray(y))
    sel = (X >= x0) & (X <= x1) & (Y >= y0) & (Y <= y1)
    vals = np.asarray(img, float)[sel]
    vals = vals[np.isfinite(vals)]
    return float(vals.mean()) if vals.size else np.nan


def collect_model_maps(model_dir, pattern="raytrace_*.npz"):
    """(freq_hz, tb_map, x_rsun, y_rsun) per sweep output, frequency-sorted.
    The frequency comes from the '<...>MHz.npz' filename when present,
    otherwise from the npz itself."""
    rows = []
    for f in sorted(Path(model_dir).glob(pattern)):
        data = np.load(f)
        m = re.search(r"([0-9]+(?:\.[0-9]+)?)MHz", f.name)
        freq_hz = (float(m.group(1)) * 1e6 if m
                   else float(np.atleast_1d(data["frequencies_Hz"])[0]))
        rows.append((freq_hz, data["emission_cube"][:, :, 0],
                     data["x_coords"] / R_SUN_M, data["y_coords"] / R_SUN_M))
    rows.sort(key=lambda r: r[0])
    return rows


def roi_spectra(model_rows, obs, rois, min_obs_k=1e5, corner=32):
    """Per-ROI spectra dict. Observed bands below min_obs_k are dropped
    (non-detections); the error is 3x the corner-patch noise std."""
    out = []
    for name, x0, x1, y0, y1 in rois:
        f_m = np.array([r[0] for r in model_rows])
        tb_m = np.array([_rect_mean(r[1], r[2], r[3], x0, x1, y0, y1)
                         for r in model_rows])
        f_o = np.asarray(obs.freqs_hz, float) if obs is not None else \
            np.empty(0)
        tb_o = np.full(f_o.shape, np.nan)
        err_o = np.full(f_o.shape, np.nan)
        for bd in range(len(f_o)):
            band = obs.img_k[bd]
            avg = _rect_mean(band, obs.x_rsun, obs.y_rsun, x0, x1, y0, y1)
            if np.isfinite(avg) and avg > min_obs_k:
                tb_o[bd] = avg
                err_o[bd] = 3.0 * float(np.nanstd(band[:corner, :corner]))
        out.append({"name": name, "freq_model_hz": f_m, "tb_model_k": tb_m,
                    "freq_obs_hz": f_o, "tb_obs_k": tb_o, "err_obs_k": err_o})
    return out


def plot_roi_spectra(spectra, out_path, ylim_mk=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(spectra)
    fig, axes = plt.subplots(n, 1, figsize=(4.8, 2.9 * n), sharex=True,
                             squeeze=False)
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    for i, (ax, sp) in enumerate(zip(axes[:, 0], spectra)):
        c = colors[i % len(colors)]
        ax.plot(sp["freq_model_hz"] / 1e6, sp["tb_model_k"] / 1e6, "s--",
                color=c, markersize=4, label="model")
        if sp["freq_obs_hz"].size:
            ax.errorbar(sp["freq_obs_hz"] / 1e6, sp["tb_obs_k"] / 1e6,
                        yerr=sp["err_obs_k"] / 1e6, fmt="o-", color=c,
                        markersize=3.5, capsize=2.5, linewidth=1.4,
                        label="observed")
        ax.annotate(sp["name"], (0.02, 0.96), xycoords="axes fraction",
                    va="top", fontweight="bold", color=c)
        ax.set_ylabel(r"mean $T_B$ (MK)")
        if ylim_mk:
            ax.set_ylim(0, ylim_mk)
        ax.legend(loc="lower right", fontsize=8)
    axes[-1, 0].set_xlabel("Frequency (MHz)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=170, bbox_inches="tight")
    plt.close(fig)


def _parse_roi(spec):
    parts = spec.split(",")
    if len(parts) not in (4, 5):
        raise argparse.ArgumentTypeError(
            "ROI must be x0,x1,y0,y1[,name] in R_sun")
    name = parts[4] if len(parts) == 5 else f"ROI({spec})"
    x0, x1, y0, y1 = (float(v) for v in parts[:4])
    return (name, x0, x1, y0, y1)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Observed vs model ROI T_b spectra from a frequency "
                    "sweep of maps plus a multi-band observation.")
    p.add_argument("--model-dir", "-m", required=True,
                   help="Directory of model sweep outputs (tb_spectra CLI)")
    p.add_argument("--model-glob", default="raytrace_*.npz")
    p.add_argument("--obs", "-b", default=None,
                   help="Multi-band observation (.fits/.hdf/.h5/.npz); "
                        "omit to plot the model spectra alone")
    p.add_argument("--h5-image-key", default=None)
    p.add_argument("--h5-freq-key", default=None)
    p.add_argument("--roi", action="append", type=_parse_roi, default=None,
                   metavar="x0,x1,y0,y1[,name]",
                   help="Rectangular ROI in R_sun (repeatable; default: "
                        "the two publication ROIs)")
    p.add_argument("--min-obs-k", type=float, default=1e5,
                   help="Observed-band detection threshold in K")
    p.add_argument("--ylim-mk", type=float, default=0.9)
    p.add_argument("--out", "-o", default="obs_spectrum.png")
    args = p.parse_args(argv)

    model_rows = collect_model_maps(args.model_dir, args.model_glob)
    if not model_rows:
        raise FileNotFoundError(
            f"no model maps matching {args.model_glob} in {args.model_dir}")
    obs = None
    if args.obs:
        obs = load_multiband_observation(args.obs, args.h5_image_key,
                                         args.h5_freq_key)
    rois = args.roi or DEFAULT_ROIS
    spectra = roi_spectra(model_rows, obs, rois, args.min_obs_k)

    for sp in spectra:
        ok = np.isfinite(sp["tb_model_k"])
        lo = sp["tb_model_k"][ok].min() / 1e6 if ok.any() else np.nan
        hi = sp["tb_model_k"][ok].max() / 1e6 if ok.any() else np.nan
        print(f"{sp['name']}: model {ok.sum()} pts "
              f"({lo:.2f}-{hi:.2f} MK), observed "
              f"{np.isfinite(sp['tb_obs_k']).sum()} pts")

    plot_roi_spectra(spectra, args.out, args.ylim_mk)
    arrays = {}
    for sp in spectra:
        tag = re.sub(r"\W+", "_", sp["name"]).strip("_")
        for k in ("freq_model_hz", "tb_model_k", "freq_obs_hz",
                  "tb_obs_k", "err_obs_k"):
            arrays[f"{tag}_{k}"] = sp[k]
    np.savez(Path(args.out).with_suffix(".npz"), **arrays)
    print(f"Saved {args.out} (+ .npz)")
    return 0


if __name__ == "__main__":
    main()
