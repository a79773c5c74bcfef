"""The reference straight-LOS map at a set of pixels: each pixel's line of
sight on the irregular z grid, the MAS fields sampled along it, the voxel
fold and the finish, as resample_mas_los and synthetic_ff compute them,
from the benchmark's MAS arrays and the configuration's settings.

The geometry is the reference scripts': the z grid dz_i = dz0 (1 + (5 i /
N_z)^2.5), z = cumsum(dz) (script/resampling_MAS_LOS.py:141-146); a
pixel's line of sight starts on the sphere (on disk) or behind the limb
plane (off disk), 1 m short of it, and marches toward the observer along
+z (:222-227); coordinates cart_to_sph(x, -z, y, phi0) (:233); NaN where
r < R_MIN. The voxels are folded in order, the far end first, into the
two-mode carry of transfer.make_voxel_update, and T_b follows
Rayleigh-Jeans (script/synthetic_FF_map_single_thread.py:189-219).

Departures from the reference scripts, each the program's contract, which
this file follows so that a sound run reads 0:
- the coordinates are float32: z_start + z summed in float64 and rounded
  once, x and y rounded from float64 (the scripts stay in float64);
- the fields are sampled trilinearly on the MAS mesh by scene.sample_sph
  in float32 (the scripts call psipy's sample_at_coords), then widened to
  float64; |B| is the float64 root of the float64 squares;
- ds is float64 dz in cm, and ne, te, b, ds are rounded to float32 for the
  fold (the scripts pass float64 to GRFF's library, one pixel a call);
- the fold is the frozen free-free voxel update of transfer.py at a fixed
  theta of 90 deg (GRFF computes its own free-free terms in C++);
- T_b and V/I are taken in float64 from the float32 fluxes, with no
  sanitisation of T_b (as synthetic_ff).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import R_MIN, R_SUN_CM, R_SUN_M
from .scene import cart_to_sph, mas_variable, sample_sph
from .transfer import log_spaced_freqs, make_voxel_update, tb_from_sfu

NAMES = ("rho", "t", "br", "bt", "bp")


def z_grid(n_z, dz0):
    """The irregular z grid: (z in R_sun, dz), float64 numpy."""
    idx = np.arange(n_z)
    dz = dz0 * (1.0 + (5.0 * idx / n_z) ** 2.5)
    return np.cumsum(dz), dz


def los_starts(n_pix, x_fov, pixels):
    """(x, y, z_start) float64 numpy of the flat `pixels` (p = i * n_pix
    + j at x_j, y_i) of an image of n_pix^2 pixels over +-x_fov."""
    xs = np.linspace(-x_fov, x_fov, n_pix)
    ys = np.linspace(-x_fov, x_fov, n_pix)
    X, Y = np.meshgrid(xs, ys)
    x, y = X.ravel()[pixels], Y.ravel()[pixels]
    rho_sq = x ** 2 + y ** 2
    z_start = np.where(
        rho_sq < 1.0,
        np.sqrt(np.maximum(1.0 - rho_sq, 0.0)) - 1e-6 / R_SUN_M,
        -np.sqrt(np.maximum(rho_sq - 1.0, 0.0)) - 1e-6 / R_SUN_M)
    return x, y, z_start


def los_samples(arrays, mesh, run, los, pixels, device, dtype):
    """(ne, te, b) float64 (len(pixels), n_z) tensors of the sampled lines
    of sight (NaN where r < R_MIN or off the mesh), and ds (n_z,) float64
    numpy in cm."""
    if not los["variable_spacing_z"]:
        raise ValueError("the reference samples the irregular z grid only")
    z_rsun, dz = z_grid(los["n_z"], los["dz0"])
    x, y, z_start = los_starts(run["n_pix"], run["x_fov"], pixels)
    f64 = torch.float64
    z = (torch.as_tensor(z_start, dtype=f64, device=device)[:, None]
         + torch.as_tensor(z_rsun, dtype=f64, device=device)[None, :]
         ).to(dtype)
    xb = torch.as_tensor(x, dtype=dtype, device=device)[:, None].expand(
        z.shape)
    yb = torch.as_tensor(y, dtype=dtype, device=device)[:, None].expand(
        z.shape)
    r, colat, lon = cart_to_sph(xb, -z, yb, run["phi0_offset"])
    valid = r >= R_MIN

    def field(name):
        data, phi, theta, r_ax = (torch.as_tensor(a, dtype=dtype,
                                                  device=device)
                                  for a in mas_variable(arrays[name], mesh,
                                                        name))
        v = sample_sph(data, phi, theta, r_ax, r, colat, lon)
        return torch.where(valid, v, float("nan")).to(f64)

    ne, te = field("rho"), field("t")
    b = torch.sqrt(sum(field(name) ** 2 for name in NAMES[2:]))
    return ne, te, b, dz * R_SUN_CM


def los_pixels(arrays, mesh, run, los, pixels, device, dtype=torch.float32):
    """(T_b, V/I) of the flat `pixels` of the straight-LOS map of `run`
    (n_pix, x_fov, phi0_offset, freq_hz) and `los` (n_z, dz0,
    variable_spacing_z, nfreq, mechanism), each (len(pixels), Nf) float64
    numpy."""
    ne, te, b, ds = los_samples(arrays, mesh, run, los, pixels, device,
                                dtype)
    flagged = ~(torch.isnan(ne) | torch.isnan(te) | torch.isnan(b))
    ds = torch.as_tensor(ds, device=device)[None, :].expand(ne.shape)

    def voxels(a, nan=0.0):
        """Step-major (n_z, len(pixels)) in the fold's precision."""
        return torch.nan_to_num(a, nan=nan).T.to(dtype)

    x_coords = (np.linspace(-run["x_fov"], run["x_fov"], run["n_pix"])
                * R_SUN_M)
    pixel_size_cm = (x_coords[1] - x_coords[0]) / R_SUN_M * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm
    frequencies_hz = log_spaced_freqs(run["freq_hz"], los["nfreq"], 0.0)
    freqs = torch.as_tensor(frequencies_hz, device=device).to(dtype)
    update = make_voxel_update(freqs, pixel_area_cm2, 90.0, los["mechanism"],
                               dtype)
    ds_v, te_v, ne_v, b_v = (voxels(ds), voxels(te, nan=1e4), voxels(ne),
                             voxels(b))
    mask = flagged.T
    sarea = torch.zeros_like(ds_v)
    z = torch.zeros((ne.shape[0], freqs.shape[0]), dtype=dtype,
                    device=device)
    carry = (z, z, z, z)
    for k in range(ds_v.shape[0]):
        carry = update(carry, ds_v[k], te_v[k], ne_v[k], b_v[k], mask[k],
                       sarea[k])

    def host(a):
        return a.cpu().float().numpy().astype(np.float64)

    intensity = host(carry[0] + carry[1])
    pol = host(carry[0] - carry[1]) / (intensity + 1e-30)
    tb = tb_from_sfu(intensity, np.asarray(frequencies_hz)[None, :],
                     pixel_area_cm2)
    return tb, pol
