"""Host-side matplotlib plots matching the reference's figure outputs
(_save_emission_plot / _save_center_pixel_plots,
script/resample_with_ray_tracing.py:552-649; LOS plots
script/resampling_MAS_LOS.py:312-371). NumPy and matplotlib only, imported
when a plot is made; the beam of save_emission_plot runs on `device`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import R_SUN_CM, R_SUN_M


def inspection_pixel_index(n_pix):
    """Flat index of the reference's center-pixel LOS inspection ray
    (p = (0.7*N//2)*N + (N-1)//2, resample_with_ray_tracing.py:554), the
    one definition shared by the plot and the streamed pipeline's
    per-segment gather."""
    return (int(n_pix * 0.7) // 2) * n_pix + ((n_pix - 1) // 2)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_emission_plot(result, n_pix, x_fov, out_path, consider_beam=False,
                       beam_fwhm=0.2, title_prefix="Ray-tracing emission",
                       device="cuda"):
    plt = _plt()
    emission_map = np.array(result["emission_cube"][:, :, 0], copy=True)
    emission_map[emission_map == 0] = np.nan
    x = result["x_coords"] / R_SUN_M
    y = result["y_coords"] / R_SUN_M

    if consider_beam:
        from .beam import gaussian_beam_convolve
        sigma_pix = beam_fwhm / (x[-1] - x[0]) * n_pix
        emission_map = gaussian_beam_convolve(
            np.nan_to_num(emission_map), sigma_pix,
            device=device).cpu().numpy()

    fig, ax = plt.subplots(figsize=(6, 4.8))
    vmax = np.nanmax(emission_map)
    im = ax.imshow(emission_map, origin="lower",
                   extent=[x[0], x[-1], y[0], y[-1]], aspect="equal",
                   cmap="hot", interpolation="bilinear",
                   vmin=0, vmax=vmax * 1.1 if np.isfinite(vmax) else None)
    ax.set_xlabel("x (R_sun)")
    ax.set_ylabel("y (R_sun)")
    freq_ghz = result["frequencies_Hz"][0] / 1e9
    ax.set_title(f"{title_prefix} T_b at {freq_ghz:.3f} GHz")
    if consider_beam:
        ax.add_patch(plt.Circle((-0.8 * x_fov, -0.8 * x_fov), beam_fwhm,
                                color="white", fill=False, linewidth=1.5))
    plt.colorbar(im, ax=ax, label="T_b (K)")
    plt.tight_layout()
    plot_path = Path(out_path).with_suffix(".png")
    plt.savefig(plot_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return plot_path


def save_center_pixel_plot(sampled, n_pix, out_path, p_index=None):
    """Ne/Te/|B|/S along the ray of the reference's inspection pixel
    (inspection_pixel_index; resample_with_ray_tracing.py:554).
    p_index overrides the column (used when rays are in binned order)."""
    plt = _plt()
    p_center = (p_index if p_index is not None
                else inspection_pixel_index(n_pix))
    valid = np.asarray(sampled.valid_mask)[:, p_center]
    if not np.any(valid):
        return None
    ne = np.asarray(sampled.ne)[:, p_center][valid]
    te = np.asarray(sampled.te)[:, p_center][valid]
    b = np.asarray(sampled.b)[:, p_center][valid]
    s = np.asarray(sampled.s)[:, p_center][valid]
    ds = np.asarray(sampled.ds)[:, p_center][valid]
    dist = np.cumsum(ds.astype(float)) / R_SUN_CM

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    for ax, ydata, label, color in (
            (axes[0, 0], ne, "N_e (cm$^{-3}$)", "b"),
            (axes[0, 1], te, "T_e (K)", "r"),
            (axes[1, 0], b, "|B| (G)", "green")):
        ax.plot(dist, ydata, color=color, linewidth=1.5)
        ax.set_xlabel("Distance along ray (R_sun)")
        ax.set_ylabel(label)
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
    axes[1, 1].plot(dist, s, "k-", linewidth=1.5)
    axes[1, 1].axhline(1.0, color="gray", linestyle="--", alpha=0.7)
    axes[1, 1].set_xlabel("Distance along ray (R_sun)")
    axes[1, 1].set_ylabel("S (cross-section ratio)")
    axes[1, 1].grid(True, alpha=0.3)
    plt.tight_layout()
    plot_path = Path(out_path).with_name(Path(out_path).stem
                                         + "_center_pixel.png")
    plt.savefig(plot_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return plot_path


def save_tb_vi_plot(result, out_path):
    """T_b and V/I side-by-side (ref: synthetic_FF_map_single_thread.py:265-286)."""
    plt = _plt()
    x = result["x_coords"] / R_SUN_M
    y = result["y_coords"] / R_SUN_M
    tb = np.array(result["emission_cube"][:, :, 0], copy=True)
    tb[tb == 0] = np.nan
    vi = np.array(result["emission_polVI_cube"][:, :, 0], copy=True)
    vi[np.isnan(tb)] = np.nan
    freq_ghz = result["frequencies_Hz"][0] / 1e9

    fig, (ax_tb, ax_vi) = plt.subplots(1, 2, figsize=(12, 4.2))
    im_tb = ax_tb.imshow(tb, origin="lower",
                         extent=[x[0], x[-1], y[0], y[-1]],
                         aspect="equal", cmap="hot",
                         interpolation="bilinear")
    ax_tb.set_title(f"$T_b$ at {freq_ghz:.3f} GHz")
    plt.colorbar(im_tb, ax=ax_tb, label="T_b (K)")
    vmax = np.nanmax(np.abs(vi))
    vmax = 1.0 if (not np.isfinite(vmax) or vmax == 0) else vmax
    im_vi = ax_vi.imshow(vi, origin="lower",
                         extent=[x[0], x[-1], y[0], y[-1]],
                         aspect="equal", cmap="RdBu_r",
                         interpolation="bilinear", vmin=-vmax, vmax=vmax)
    ax_vi.set_title(f"V/I at {freq_ghz:.3f} GHz")
    plt.colorbar(im_vi, ax=ax_vi, label="V/I")
    for ax in (ax_tb, ax_vi):
        ax.set_xlabel("x (R_sun)")
        ax.set_ylabel("y (R_sun)")
    plt.tight_layout()
    plot_path = Path(str(out_path) + "_Tb_VI.png")
    plt.savefig(plot_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return plot_path
