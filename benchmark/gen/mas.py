"""The seeded synthetic MAS corona: a frozen copy of
raytracinggrff_tpu_torch/mas/model.synthetic_mas_model, changed so that a
seed draws the density structure and not its scale.

    n_e = 4.2e4 * 10^(4.32 / r) * (1 + a cos(2 (phi - psi)) sin^2 theta)

with the amplitude a and the phase psi drawn from the configuration's
ranges ("scene" of the configuration file). The program's own model is
a = 0.3, psi = 0, inside those ranges. Temperature and the dipole field
are those of the copied model. The mesh is the configuration's and the
same for every seed, so every seed asks for the same work.

mas_arrays gives the fields in the code units written to disk (float32,
(phi, theta, r) order) with the mesh; write_mas_dir writes them as the
{var}NNN.hdf files that the program's MASModel reads. The reference takes
the same arrays before they were written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..reference.constants import MAS_UNITS
from .hdf4 import write_hdf4_sds

NAMES = ("rho", "t", "br", "bt", "bp")


def seed_rng(seed, stream=0):
    """A numpy generator of `seed` (any whole number) for one named
    stream: 0 draws the scene, 1 the samples the check compares."""
    return np.random.default_rng([int(seed) % 2 ** 64, int(stream)])


def draw_structure(scene, seed):
    """(amplitude, phase) of the azimuthal modulation for `seed`, from the
    scene's ranges."""
    rng = seed_rng(seed, 0)
    lo, hi = scene["modulation_amplitude"]
    p_lo, p_hi = scene["modulation_phase_rad"]
    return float(rng.uniform(lo, hi)), float(rng.uniform(p_lo, p_hi))


def mas_mesh(scene):
    """(phi, theta, r) axes of the scene, float64."""
    phi = np.linspace(0, 2 * np.pi, scene["nphi"], endpoint=False)
    theta = np.linspace(0.02, np.pi - 0.02, scene["ntheta"])
    r = 1.0 + (scene["r_max"] - 1.0) * (np.linspace(0, 1, scene["nr"])
                                        ** 1.5)
    return phi, theta, r


def mas_arrays(scene, seed):
    """{name: float32 (nphi, ntheta, nr) field in code units} and the mesh
    (phi, theta, r) of the seeded model."""
    amp, psi = draw_structure(scene, seed)
    phi, theta, r = mas_mesh(scene)
    P, T, R = np.meshgrid(phi, theta, r, indexing="ij")
    b0 = scene["b0_gauss"]
    ne = 4.2e4 * 10 ** (4.32 / R)
    ne = ne * (1.0 + amp * np.cos(2 * (P - psi)) * np.sin(T) ** 2)
    te = 1.4e6 * (1.0 - 0.25 * np.exp(-(R - 1.0) / 0.3)) * np.ones_like(ne)
    br = 2 * b0 * np.cos(T) / R ** 3
    bt = b0 * np.sin(T) / R ** 3
    bp = 0.1 * b0 * np.sin(T) / R ** 3
    fields = {"rho": ne, "t": te, "br": br, "bt": bt, "bp": bp}
    arrays = {name: (fields[name] / MAS_UNITS[name]).astype(np.float32)
              for name in NAMES}
    return arrays, (phi, theta, r)


def write_mas_dir(path, arrays, mesh, timestep):
    """Write the fields as {name}{timestep:03d}.hdf HDF4 files into the
    directory `path`. Returns the path."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    for name, data in arrays.items():
        write_hdf4_sds(path / f"{name}{timestep:03d}.hdf", data,
                       scales=list(mesh), label=name)
    return path
