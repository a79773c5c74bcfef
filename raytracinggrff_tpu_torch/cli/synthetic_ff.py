"""Synthetic free-free map CLI from LOS data on a torch device
(script/synthetic_FF_map_single_thread.py:315-331); the flags of the JAX
package's rgrff-synthetic-ff plus --device (default cuda).

    python -m raytracinggrff_tpu_torch.cli.synthetic_ff -i LOS_data.npz
"""

from __future__ import annotations

import argparse

import numpy as np

from ..pipeline import synthetic_ff


def build_parser():
    p = argparse.ArgumentParser(
        description="Synthetic free-free emission via the native GRFF "
                    "transfer.")
    p.add_argument("--input", "-i", type=str, default="LOS_data.npz")
    p.add_argument("--output", "-o", type=str, default="emission_map")
    p.add_argument("--freq0", "-f", type=float, default=450e6)
    p.add_argument("--Nfreq", "-n", type=int, default=4)
    p.add_argument("--freq-log-step", "-s", type=float, default=0.1)
    p.add_argument("--do-inspection-plot", action="store_true")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the transfer (default: cuda)")
    p.add_argument("--quiet", "-q", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    result = synthetic_ff(args.input, args.freq0, args.Nfreq,
                          args.freq_log_step, out_path=args.output,
                          verbose=not args.quiet, device=args.device)
    if not args.quiet:
        tb = result["emission_cube"][:, :, 0]
        n_pix = tb.shape[0]
        c0, c1 = n_pix // 2 - 8, n_pix // 2 + 8
        center = tb[max(c0, 0):c1, max(c0, 0):c1]
        center = center[center > 0]
        if center.size:
            print(f"Average brightness temperature (center, first freq): "
                  f"{np.mean(center):.2e} K")
    if not args.no_plots:
        from ..utils.plotting import save_emission_plot, save_tb_vi_plot
        save_emission_plot(result, result["emission_cube"].shape[0],
                           1.44, args.output + ".npz",
                           title_prefix="synthetic", device=args.device)
        save_tb_vi_plot(result, args.output)
    return 0


if __name__ == "__main__":
    main()
