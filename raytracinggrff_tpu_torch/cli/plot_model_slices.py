"""Model z=0-plane slices of Ne/Te/|B| with on-disk sphere projection.

Capability of script/pub/plot_model_z0_slices.py (sample_plane :65-119):
samples the MAS model on the image z=0 plane; points with r < 1 are
projected onto the solar sphere surface facing the observer (the "disk"),
giving the characteristic disk + off-limb composite maps.

The port of raytracinggrff_tpu/cli/plot_model_slices.py: the plane's
spherical coordinates and the samples are computed on --device (default
cuda) with MASVariable.sample_sph; the polar cuts and the figures stay
numpy and matplotlib.

    python -m raytracinggrff_tpu_torch.cli.plot_model_slices -m ./corona
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..coords import image_xyz_to_mas_sph
from ..mas.model import MASModel


def sample_plane(model, n_pix=512, extent=2.0, phi0_offset=0.0,
                 device="cuda"):
    """Ne, Te and |B| on the image z = 0 plane (n_pix^2 points over
    [-extent, extent]^2, on-disk points projected onto the visible
    hemisphere), sampled on `device`; returns numpy float32 maps and the
    plot extent."""
    xs = np.linspace(-extent, extent, n_pix)
    ys = np.linspace(-extent, extent, n_pix)
    X, Y = np.meshgrid(xs, ys)
    rho2 = X ** 2 + Y ** 2
    # on-disk: project onto the sphere surface toward the observer (+z)
    on_disk = rho2 < 1.0
    Z = np.where(on_disk, np.sqrt(np.maximum(1.0 - rho2, 0.0)), 0.0)

    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    r, colat, lon = image_xyz_to_mas_sph(t(X), t(Y), t(Z),
                                         float(phi0_offset))
    r = torch.clamp(r, min=1.0000001)

    def sample(name):
        return model[name].sample_sph(r, colat, lon, device=device)

    out = {}
    temp_var = model.temperature_variable()
    out["ne"] = sample("rho").cpu().numpy()
    out["te"] = sample(temp_var).cpu().numpy()
    b2 = sum(sample(v) ** 2 for v in ("br", "bt", "bp"))
    out["b"] = torch.sqrt(b2).cpu().numpy()
    out["extent"] = [-extent, extent, -extent, extent]
    return out


def polar_cuts(var, r_max=4.0):
    """Equatorial (theta=pi/2) and meridional (phi nearest 0 or pi) cuts
    straight off the native MAS mesh (capability of plot_model.py:
    equatorial + phi polar cuts of the raw model, no resampling).

    Returns dict with 'eq' (phi x r values, phi, r) and 'mer'
    (theta x r values, theta, r, phi_deg of the cut)."""
    data, phi, theta, r = var.data, var.phi, var.theta, var.r
    rsel = r <= r_max
    it = int(np.argmin(np.abs(theta - np.pi / 2)))
    eq = data[:, it, :][:, rsel]                       # (nphi+1, nr')

    # prefer whichever of phi=0 / phi=180 deg the mesh lands closer to
    # (same tie-break as the reference, plot_model.py:33-44)
    i0 = int(np.argmin(np.abs(phi)))
    i180 = int(np.argmin(np.abs(phi - np.pi)))
    ip = i0 if abs(phi[i0]) < abs(phi[i180] - np.pi) else i180
    mer = data[ip, :, :][:, rsel]                      # (ntheta, nr')
    return {"eq": (eq, phi, r[rsel]),
            "mer": (mer, theta, r[rsel]),
            "phi_cut_deg": float(np.rad2deg(phi[ip]))}


def save_polar_plot(cuts, out_path, label="N$_e$ (cm$^{-3}$)",
                    vmin=5e4, vmax=1e9):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    norm = LogNorm(vmin=vmin, vmax=vmax)
    fig = plt.figure(figsize=(12, 5))
    eq, phi, r_eq = cuts["eq"]
    ax1 = fig.add_subplot(121, projection="polar")
    pm = ax1.pcolormesh(phi, r_eq, np.maximum(eq, vmin * 1e-3).T,
                        norm=norm, cmap="viridis", shading="auto")
    ax1.set_title("Equatorial cut (θ=90°)", pad=20)
    fig.colorbar(pm, ax=ax1, label=label)

    mer, theta, r_mer = cuts["mer"]
    ax2 = fig.add_subplot(122, projection="polar")
    # plot colatitude as the polar angle so the pole is 'up'
    pm = ax2.pcolormesh(np.pi / 2 - theta, r_mer,
                        np.maximum(mer, vmin * 1e-3).T,
                        norm=norm, cmap="viridis", shading="auto")
    ax2.set_title(f"Meridional cut (φ={cuts['phi_cut_deg']:.1f}°)", pad=20)
    fig.colorbar(pm, ax=ax2, label=label)
    for ax in (ax1, ax2):
        ax.set_rlim(0, float(r_eq.max()))
    plt.tight_layout()
    plt.savefig(out_path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def build_parser():
    p = argparse.ArgumentParser(
        description="Plot z=0-plane Ne/Te/|B| slices of a MAS model, or "
                    "polar equatorial/meridional cuts (--polar).")
    p.add_argument("--model-path", "-m", default="./corona")
    p.add_argument("--n-pix", type=int, default=512)
    p.add_argument("--extent", type=float, default=2.0)
    p.add_argument("--phi0-offset", type=float, default=0.0)
    p.add_argument("--polar", action="store_true",
                   help="Polar equatorial + meridional density cuts on the "
                        "native MAS mesh (plot_model.py capability)")
    p.add_argument("--var", default="rho",
                   help="Variable for --polar cuts (default: rho)")
    p.add_argument("--r-max", type=float, default=4.0)
    p.add_argument("--out", "-o", default="model_z0_slices.png")
    p.add_argument("--device", default="cuda",
                   help="torch device of the plane's sampling (default: "
                        "cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.polar:
        model = MASModel(args.model_path)
        cuts = polar_cuts(model[args.var], r_max=args.r_max)
        label = ("N$_e$ (cm$^{-3}$)" if args.var == "rho"
                 else f"{args.var} (model units)")
        save_polar_plot(cuts, args.out, label=label)
        print(f"Saved {args.out}")
        return 0

    model = MASModel(args.model_path)
    data = sample_plane(model, args.n_pix, args.extent, args.phi0_offset,
                        device=args.device)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    with np.errstate(divide="ignore", invalid="ignore"):
        panels = [(axes[0], np.log10(data["ne"]), "log N_e (cm$^{-3}$)",
                   "viridis"),
                  (axes[1], np.log10(data["te"]), "log T_e (K)", "plasma"),
                  (axes[2], np.log10(data["b"]), "log |B| (G)", "hot")]
    for ax, arr, label, cmap in panels:
        im = ax.imshow(arr, origin="lower", extent=data["extent"],
                       aspect="equal", cmap=cmap)
        ax.add_patch(plt.Circle((0, 0), 1.0, edgecolor="white",
                                facecolor="none", linewidth=1.0,
                                linestyle=":"))
        ax.set_xlabel("x (R_sun)")
        ax.set_ylabel("y (R_sun)")
        plt.colorbar(im, ax=ax, label=label)
    plt.tight_layout()
    plt.savefig(args.out, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Saved {args.out}")
    return 0


if __name__ == "__main__":
    main()
