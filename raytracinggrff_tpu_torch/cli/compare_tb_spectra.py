"""Model T_b spectrum vs literature / observation points.

Capability of script/pub/compare_Tb_spectra.py: load the per-frequency
raytrace_*.npz maps from a spectral sweep (tb_spectra CLI), compute
ROI-averaged brightness temperatures, and plot against reference points
(CSV with columns freq_mhz, tb_k). Built-in quiet-Sun literature anchor
points span 0.3-0.8 MK over 20-90 MHz (BASELINE.md physics sanity anchor).

The port's copy of raytracinggrff_tpu/cli/compare_tb_spectra.py (numpy and
matplotlib; no device work):

    python -m raytracinggrff_tpu_torch.cli.compare_tb_spectra --mfs-dir mfs
"""

from __future__ import annotations

import argparse
import re
from pathlib import Path

import numpy as np

from ..constants import R_SUN_M

# Quiet-Sun T_b literature anchors (approximate values of the compilation
# used by the reference's plot_Tb_spec notebook)
QUIET_SUN_POINTS_MHZ_K = [
    (20.0, 3.0e5), (30.0, 4.0e5), (45.0, 5.5e5), (60.0, 6.5e5),
    (80.0, 7.5e5), (150.0, 8.0e5), (300.0, 6.0e5), (600.0, 3.0e5),
]


def load_model_spectrum(mfs_dir, roi_rsun=1.0):
    """ROI-averaged T_b per frequency from raytrace_*.npz sweep outputs."""
    mfs_dir = Path(mfs_dir)
    rows = []
    for f in sorted(mfs_dir.glob("raytrace_*.npz")):
        m = re.search(r"([0-9]+\.[0-9]+)MHz", f.name)
        if not m:
            continue
        freq_hz = float(m.group(1)) * 1e6
        data = np.load(f)
        tb = data["emission_cube"][:, :, 0]
        x = data["x_coords"] / R_SUN_M
        y = data["y_coords"] / R_SUN_M
        X, Y = np.meshgrid(x, y)
        roi = (X ** 2 + Y ** 2) < roi_rsun ** 2
        vals = tb[roi]
        vals = vals[vals > 0]
        if vals.size:
            rows.append((freq_hz, float(np.mean(vals))))
    return np.array(rows)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Compare model T_b spectrum against literature points.")
    p.add_argument("--mfs-dir", default="mfs",
                   help="Directory of raytrace_*.npz sweep outputs")
    p.add_argument("--points-csv", default=None,
                   help="CSV of freq_mhz,tb_k reference points "
                        "(default: built-in quiet-Sun anchors)")
    p.add_argument("--roi-rsun", type=float, default=1.0)
    p.add_argument("--out", "-o", default="compare_Tb_spectra.png")
    args = p.parse_args(argv)

    model = load_model_spectrum(args.mfs_dir, args.roi_rsun)
    if model.size == 0:
        raise FileNotFoundError(
            f"No raytrace_*.npz maps found in {args.mfs_dir}; run the "
            "tb_spectra sweep first.")

    if args.points_csv:
        pts = np.loadtxt(args.points_csv, delimiter=",")
    else:
        pts = np.array(QUIET_SUN_POINTS_MHZ_K)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.loglog(model[:, 0] / 1e6, model[:, 1], "o-", label="model (ROI avg)")
    ax.loglog(pts[:, 0], pts[:, 1], "s", color="gray",
              label="literature quiet Sun")
    ax.set_xlabel("Frequency (MHz)")
    ax.set_ylabel(r"$T_b$ (K)")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    plt.tight_layout()
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved {args.out}")
    return 0


if __name__ == "__main__":
    main()
