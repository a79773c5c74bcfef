"""The reference map at a set of pixels: the scene cubes, the traced
records of those pixels' rays, their fold and the finish, as
run_ray_tracing_emission computes them, from the benchmark's MAS arrays
and the map's settings."""

from __future__ import annotations

import numpy as np
import torch

from .constants import R_SUN_CM
from .scene import Grid, image_ray_starts, scene_cubes
from .trace import trace_records
from .transfer import finish, fold_records, log_spaced_freqs


def map_pixels(arrays, mesh, run, pixels, device, dtype=torch.float32):
    """(T_b, V/I) of the flat `pixels` (p = i * n_pix + j) of the map of
    `run` (the RayEmissionConfig fields of a map), each (len(pixels), Nf)
    float64 numpy."""
    fixed = dict(theta_mode="fixed", gaunt="dulk", s_mode="cumulative")
    if any(run.get(k, v) != v for k, v in fixed.items()):
        raise ValueError(f"the reference maps {fixed} only")
    recs = trace_pixels(arrays, mesh, run, pixels, device, dtype)
    _, _, start, _ = image_ray_starts(run["n_pix"], run["x_fov"],
                                      run["z_observer"])
    freq0 = run["freq0"] or run["freq_hz"]
    frequencies_hz = log_spaced_freqs(freq0, run["nfreq"],
                                      run["freq_log_step"])
    pixel_size_cm = (2 * run["x_fov"]) / run["n_pix"] * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm
    freqs = torch.as_tensor(frequencies_hz, device=device).to(dtype)
    flux_o, flux_x = fold_records(recs, start[pixels], freqs, pixel_area_cm2,
                                  run["theta_deg"], run["mechanism"],
                                  run["s_input_on"], dtype)
    return finish(flux_o, flux_x, frequencies_hz, pixel_area_cm2, dtype)


def trace_pixels(arrays, mesh, run, rays, device, dtype=torch.float32):
    """Records (n_records, 8, len(rays)) of the rays `rays` (flat pixel
    indices) of `run`'s image plane, traced through the scene cubes."""
    grid = Grid.cube(run["grid_extent"], run["grid_n"])
    cubes = scene_cubes(arrays, mesh, grid, run["phi0_offset"], device,
                        dtype)
    _, _, start, kdir = image_ray_starts(run["n_pix"], run["x_fov"],
                                         run["z_observer"])
    return trace_records(cubes, grid, run["freq_hz"], start[rays],
                         kdir[rays], run["dt"], run["n_steps"],
                         run["record_stride"], run["perturb_ratio"], dtype)


def as_numpy(a):
    """A tensor as float64 numpy."""
    return a.detach().cpu().float().numpy().astype(np.float64)
