"""Ray-trajectory demo on PyTorch/CUDA: trace limb rays through the
trace-segment kernel and plot them over the omega_pe slice (capability
of the reference package demo, build_rays.py:251-395, and the JAX
package's rgrff-demo-rays).

The model variable is resampled on --device (default cuda), the rays are
traced there by the kernel with cross-sections off and the record
schedule of the JAX tracer's trace_rays (first record after one step,
then one every --record-stride steps), and the records come to the host
for the plot.

    python -m raytracinggrff_tpu_torch.cli.demo_rays -m ./corona
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..constants import FPE_COEF
from ..grids import UniformGrid
from ..mas.model import MASModel, resample_var_to_cube
from ..tracer_segments import trace_rays_segments


def plot_rays(omega_pe_3d, grid, r_record, out_path, y_index=None):
    """x-z slice of omega_pe with ray paths overlaid
    (ref: plot_rays build_rays.py:251-280)."""
    from ..utils.plotting import _plt
    plt = _plt()

    if y_index is None:
        y_index = grid.ny // 2
    xs, _, zs = grid.axes()
    plt.figure(dpi=150)
    slice_data = np.asarray(omega_pe_3d)[:, y_index, :].T
    slice_plot = np.where(np.isfinite(slice_data), slice_data, 0.0)
    im = plt.imshow(np.log10(slice_plot + 1e-30),
                    extent=[xs[0], xs[-1], zs[0], zs[-1]],
                    origin="lower", vmin=6, vmax=9.5)
    plt.colorbar(im, label="log10(omega_pe)")
    r_record = np.asarray(r_record)
    for i in range(r_record.shape[1]):
        xr = r_record[:, i, 0]
        zr = r_record[:, i, 2]
        mask = np.isfinite(xr) & np.isfinite(zr)
        if np.any(mask):
            plt.plot(xr[mask], zr[mask], "w", linewidth=0.8)
    if r_record.shape[1] > 0:
        mid = r_record.shape[1] // 2
        plt.plot(r_record[:, mid, 0], r_record[:, mid, 2], "r",
                 linewidth=1.2)
    plt.xlabel("x (R_sun)")
    plt.ylabel("z (R_sun)")
    plt.xlim(xs[0], xs[-1])
    plt.ylim(zs[0], zs[-1])
    plt.tight_layout()
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()


def build_parser():
    p = argparse.ArgumentParser(
        description="Resample MAS model to xyz cube, ray trace, and plot "
                    "rays.")
    p.add_argument("--model-path", "-m", type=str, default="./corona")
    p.add_argument("--var", type=str, default="rho")
    p.add_argument("--grid-min", type=float, default=-4.0)
    p.add_argument("--grid-max", type=float, default=4.0)
    p.add_argument("--grid-n", type=int, default=300)
    p.add_argument("--freq-mhz", type=float, default=75.0)
    p.add_argument("--start-x", type=float, default=3.999)
    p.add_argument("--start-y", type=float, default=0.0)
    p.add_argument("--z-start-min", type=float, default=-1.5)
    p.add_argument("--z-start-max", type=float, default=1.5)
    p.add_argument("--n-rays", type=int, default=18)
    p.add_argument("--dt", type=float, default=10e-3)
    p.add_argument("--n-steps", type=int, default=6000)
    p.add_argument("--record-stride", type=int, default=10)
    p.add_argument("--out-plot", type=str, default="rays.png")
    p.add_argument("--fill-nan", type=float, default=0.0)
    p.add_argument("--phi0-offset", type=float, default=24.0,
                   help="demo default matches build_rays PHI0_OFFSET=24")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the resample and the trace "
                        "(default: cuda)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def trace_demo_rays(args):
    """Resample args.var, make omega_pe as demo_rays.py:93-94 of the JAX
    package does, and trace the limb rays through the kernel on
    args.device. Returns (omega_pe (n, n, n) tensor on the device, grid,
    r_record (n_records, n_rays, 3) numpy)."""
    model = MASModel(args.model_path)
    g = np.linspace(args.grid_min, args.grid_max, args.grid_n)
    grid = UniformGrid.from_arrays(g, g, g)
    if not args.quiet:
        print(f"Resampling {args.var} onto xyz grid: {args.grid_n}^3 on "
              f"{args.device}")
    rho = resample_var_to_cube(model[args.var], grid,
                               phi0_offset_deg=args.phi0_offset,
                               fill_nan=args.fill_nan, device=args.device)
    omega_pe = FPE_COEF * torch.sqrt(torch.clamp(rho, min=0.0)) * 2 * np.pi
    omega_pe = torch.nan_to_num(omega_pe)

    z_start = np.linspace(args.z_start_min, args.z_start_max, args.n_rays)
    start = np.column_stack([
        np.full_like(z_start, args.start_x),
        np.full_like(z_start, args.start_y), z_start]).astype(np.float32)
    kdir = np.tile(np.float32([[-1, 0, 0]]), (args.n_rays, 1))
    if not args.quiet:
        print("Tracing rays...")
    # the kernel samples a model cube at each record; the demo reads only
    # the positions, so the density stands in with zero te and b
    zero = torch.zeros_like(omega_pe)
    res = trace_rays_segments(omega_pe, rho, zero, zero, grid,
                              args.freq_mhz * 1e6, start, kdir, args.dt,
                              args.n_steps, args.record_stride,
                              trace_crosssections=False)
    return omega_pe, grid, res.r_record


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.quiet:
        print(f"Loading MAS model from {args.model_path}...")
    omega_pe, grid, r_record = trace_demo_rays(args)
    if not args.quiet:
        print(f"Plotting rays to {args.out_plot}...")
    plot_rays(omega_pe.cpu().numpy(), grid, r_record, args.out_plot)
    if not args.quiet:
        print("Done.")
    return 0


if __name__ == "__main__":
    main()
