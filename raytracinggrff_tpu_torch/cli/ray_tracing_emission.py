"""Ray-tracing emission map CLI on PyTorch/CUDA.

The flags of the JAX package's rgrff-ray-emission (reference main,
script/resample_with_ray_tracing.py:652-730). --device selects the torch
device (default cuda); --workers, --grff-lib, --grff-backend,
--raytrace-device and --no-fallback are accepted for compatibility and do
nothing. Besides the .npz it writes the map and center-pixel pngs unless
--no-plots is given.

    python -m raytracinggrff_tpu_torch.cli.ray_tracing_emission -m ./corona
"""

from __future__ import annotations

import argparse

from ..pipeline import RayEmissionConfig, run_ray_tracing_emission


def build_parser():
    p = argparse.ArgumentParser(
        description="Ray-tracing emission map: resample MAS along rays and "
                    "run the GRFF transfer on a torch device.")
    p.add_argument("--model-path", "-m", type=str, default="./corona",
                   help="MAS model directory (default: ./corona)")
    p.add_argument("--N-pix", "-n", type=int, default=32,
                   help="Image size N_pix x N_pix (default: 32)")
    p.add_argument("--X-FOV", "-f", type=float, default=1.44,
                   help="Half FOV in R_sun (default: 1.44)")
    p.add_argument("--freq", type=float, default=75e6,
                   help="Ray frequency in Hz (default: 75e6)")
    p.add_argument("--grid-n", type=int, default=128,
                   help="3D grid points per axis (default: 128)")
    p.add_argument("--grid-extent", type=float, default=3.0,
                   help="3D grid extent in R_sun (default: 3)")
    p.add_argument("--z-observer", type=float, default=3.0,
                   help="Ray start z in R_sun (default: 3)")
    p.add_argument("--dt", type=float, default=6e-3,
                   help="Ray integrator dt (default: 6e-3)")
    p.add_argument("--n-steps", type=int, default=5000,
                   help="Ray integration steps (default: 5000)")
    p.add_argument("--record-stride", type=int, default=10,
                   help="Record every N steps (default: 10)")
    p.add_argument("--workers", "-w", type=int, default=1,
                   help="(compat) process workers; unused")
    p.add_argument("--out-path", "-o", type=str,
                   default="ray_tracing_emission.npz",
                   help="Output npz path")
    p.add_argument("--grff-lib", type=str, default=None,
                   help="(compat) GRFF .so path; the transfer is native")
    p.add_argument("--grff-backend", type=str, default="native",
                   choices=["native", "get_mw", "fastgrff"],
                   help="(compat) all backends map to the native transfer")
    p.add_argument("--s-input-on", action="store_true",
                   help="Pass cross-section ratio S as per-voxel source area")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the whole pipeline (default: cuda)")
    p.add_argument("--raytrace-device", type=str, default="cuda",
                   help="(compat) the tracer runs on --device")
    p.add_argument("--perturb-ratio", type=float, default=2.0,
                   help="Cross-section perturbation ratio (default: 2)")
    p.add_argument("--consider-beam", action="store_true",
                   help="Convolve emission map plot with a Gaussian beam")
    p.add_argument("--beam-fwhm", type=float, default=0.2,
                   help="Beam FWHM in R_sun (default: 0.2)")
    p.add_argument("--phi0-offset", type=float, default=0.0,
                   help="Longitude offset (deg) for MAS spherical coords")
    p.add_argument("--no-fallback", action="store_true",
                   help="(compat) no-op")
    p.add_argument("--no-plots", action="store_true",
                   help="Do not save plots")
    p.add_argument("--quiet", "-q", action="store_true", help="Less output")
    p.add_argument("--nfreq", type=int, default=1,
                   help="Number of GRFF frequency channels (default: 1)")
    p.add_argument("--freq-log-step", type=float, default=0.0,
                   help="log10 step between channels (default: 0)")
    p.add_argument("--mechanism", type=int, default=1 + 4,
                   help="Emission mechanism flags (Parms[6] contract): "
                        "1 free-free, +2 gyroresonance, +4 neutral-H "
                        "(default: 5)")
    p.add_argument("--theta-deg", type=float, default=90.0,
                   help="Angle between B and the LOS in degrees "
                        "(Parms[4] contract; default: 90)")
    p.add_argument("--theta-mode", type=str, default="fixed",
                   choices=["fixed", "los"],
                   help="'fixed': --theta-deg everywhere (reference "
                        "behavior); 'los': per-voxel theta(B, k) sampled "
                        "along each ray -> signed Stokes V maps")
    p.add_argument("--gaunt", type=str, default="dulk",
                   choices=["dulk", "exact"],
                   help="Free-free Gaunt factor: 'dulk' (Dulk 1985 "
                        "lnLambda, reference parity) or 'exact' "
                        "(classical/Born)")
    p.add_argument("--timestep", type=int, default=0,
                   help="Timestep index for multi-timestep model dirs")
    p.add_argument("--patch-nan", action="store_true",
                   help="Fill failed (non-finite) pixels with "
                        "nearest-finite neighbor means")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = RayEmissionConfig(
        n_pix=args.N_pix, x_fov=args.X_FOV, freq_hz=args.freq,
        grid_n=args.grid_n, grid_extent=args.grid_extent,
        z_observer=args.z_observer, dt=args.dt, n_steps=args.n_steps,
        record_stride=args.record_stride, s_input_on=args.s_input_on,
        nfreq=args.nfreq, freq0=args.freq,
        freq_log_step=args.freq_log_step,
        perturb_ratio=args.perturb_ratio, phi0_offset=args.phi0_offset,
        mechanism=args.mechanism, theta_deg=args.theta_deg,
        theta_mode=args.theta_mode, gaunt=args.gaunt)
    run_ray_tracing_emission(
        model_path=args.model_path, config=cfg, out_path=args.out_path,
        save_plots=not args.no_plots, verbose=not args.quiet,
        consider_beam=args.consider_beam,
        beam_fwhm=args.beam_fwhm, patch_nan=args.patch_nan,
        timestep=args.timestep, device=args.device)


if __name__ == "__main__":
    main()
