"""SDO context figure (AIA 304 / AIA 171 / HMI magnetogram) from LOCAL files.

Capability of script/pub/plot_SDO_context.py:100-130: the 3-panel labeled
context figure — AIA panels in gray, HMI magnetogram on a symmetric
diverging scale from the 1/99 percentiles (:115-118). The reference FETCHES
JPEG2000 images from Helioviewer via hvpy (:68-98); fetching is out of
scope (hvpy is a web service wrapper, not physics) — instead the inputs
are user-supplied local files read with the port's own FITS reader
(utils/fits.py). The port's copy of raytracinggrff_tpu/cli/sdo_context.py
(numpy and matplotlib; no device work):

    python -m raytracinggrff_tpu_torch.cli.sdo_context --aia304 aia304.fits \
        --aia171 aia171.fits --hmi hmi_mag.fits --datetime 2025-06-08T20:00 \
        -o SDO_context.png

Each input may be a FITS image (first image HDU) or an .npz with a 'map'
key. Note: the reference computes a TwoSlopeNorm for the HMI panel but
never passes it to imshow (plot_SDO_context.py:117-119); here the
symmetric limits are actually applied, which is the evident intent.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..utils.fits import load_observation_map


def load_panel(path):
    img, _, _, _ = load_observation_map(path)
    return np.asarray(img, np.float64)


def plot_sdo_context(aia304, aia171, hmi, out_path, title_time=None):
    """Render the 3-panel context figure; returns the output path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(7, 2.8))
    for ax, img, name, label in ((axes[0], aia304, "AIA 304", "(a)"),
                                 (axes[1], aia171, "AIA 171", "(b)")):
        ax.imshow(img, origin="upper", cmap="gray")
        ax.set_title(name)
        ax.axis("off")
        ax.text(0.02, 0.98, label, transform=ax.transAxes, va="top",
                ha="left", fontsize=12, fontweight="bold", color="white")

    # symmetric diverging scale about zero from the 1/99 percentiles
    # (plot_SDO_context.py:115-118)
    v = np.nanpercentile(hmi, [1, 99])
    vmax = max(abs(v[0]), abs(v[1]), 1.0)
    axes[2].imshow(hmi, origin="upper", cmap="RdBu_r", vmin=-vmax,
                   vmax=vmax)
    axes[2].set_title("HMI magnetogram")
    axes[2].axis("off")
    axes[2].text(0.02, 0.98, "(c)", transform=axes[2].transAxes, va="top",
                 ha="left", fontsize=12, fontweight="bold", color="white")

    if title_time:
        fig.suptitle(f"SDO context — {title_time}", fontsize=11)
    plt.tight_layout()
    fig.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(
        description="3-panel SDO context figure (AIA 304/171 + HMI "
                    "magnetogram) from local FITS/npz files. Downloading "
                    "is out of scope — fetch the images yourself (e.g. "
                    "JSOC/Helioviewer exports) and pass the paths.")
    p.add_argument("--aia304", required=True,
                   help="local AIA 304 A image (FITS or npz with 'map')")
    p.add_argument("--aia171", required=True,
                   help="local AIA 171 A image")
    p.add_argument("--hmi", required=True,
                   help="local HMI LOS magnetogram")
    p.add_argument("--datetime", "-d", default=None,
                   help="observation time label for the figure title")
    p.add_argument("-o", "--out", default="SDO_context.png",
                   help="output figure path")
    args = p.parse_args(argv)

    plot_sdo_context(load_panel(args.aia304), load_panel(args.aia171),
                     load_panel(args.hmi), args.out,
                     title_time=args.datetime)
    print(f"Saved {args.out}")


if __name__ == "__main__":
    main()
