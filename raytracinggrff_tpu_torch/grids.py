"""Uniform-grid specification of the Cartesian cube, and the z-grids of
the straight line of sight.

Samplers take a `UniformGrid` (origin, spacing, shape as Python numbers)
rather than coordinate arrays; validation happens once, on the host
(reference rules: gpu_raytrace.py:21-33).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def check_uniform_grid(grid, name: str = "grid") -> tuple[float, float]:
    """Validate a 1D uniformly spaced grid; return (origin, step)."""
    g = np.asarray(grid, dtype=np.float64)
    if g.ndim != 1 or g.size < 2:
        raise ValueError(f"{name} must be 1D with at least 2 points")
    d = np.diff(g)
    step = float(np.mean(d))
    if not np.isfinite(step) or step <= 0.0:
        raise ValueError(f"{name} has invalid spacing")
    max_dev = float(np.max(np.abs(d - step)))
    tol = max(1e-6 * abs(step), 1e-7 * max(abs(g[0]), abs(g[-1]), 1.0))
    if max_dev > tol:
        raise ValueError(f"{name} must be uniformly spaced")
    return float(g[0]), step


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """A regular xyz cube domain; every field is a Python float or int."""

    x0: float
    y0: float
    z0: float
    dx: float
    dy: float
    dz: float
    nx: int
    ny: int
    nz: int

    @classmethod
    def from_arrays(cls, x_grid, y_grid, z_grid) -> "UniformGrid":
        x0, dx = check_uniform_grid(x_grid, "x_grid")
        y0, dy = check_uniform_grid(y_grid, "y_grid")
        z0, dz = check_uniform_grid(z_grid, "z_grid")
        return cls(x0, y0, z0, dx, dy, dz,
                   int(len(x_grid)), int(len(y_grid)), int(len(z_grid)))

    @classmethod
    def cube(cls, extent: float, n: int) -> "UniformGrid":
        """Symmetric cube [-extent, extent]^3 with n points per axis."""
        g = np.linspace(-extent, extent, n)
        return cls.from_arrays(g, g, g)

    @property
    def origin(self):
        return (self.x0, self.y0, self.z0)

    @property
    def inv_steps(self):
        return (1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz)

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    def axes(self):
        """Host-side coordinate arrays (np.float64)."""
        xs = self.x0 + self.dx * np.arange(self.nx)
        ys = self.y0 + self.dy * np.arange(self.ny)
        zs = self.z0 + self.dz * np.arange(self.nz)
        return xs, ys, zs

    def meshgrid(self, dtype=torch.float32, device="cuda"):
        """The cube's (x, y, z) coordinate tensors, each (nx, ny, nz) with
        'ij' indexing, as `dtype` on `device`."""
        return torch.meshgrid(*(torch.as_tensor(a, dtype=dtype, device=device)
                                for a in self.axes()), indexing="ij")


def variable_z_grid(n_z: int, dz0: float) -> tuple[np.ndarray, np.ndarray]:
    """Irregular LOS z-grid concentrating resolution near the surface:
    dz_i = dz0 * (1 + (5 i / N_z)^2.5), z = cumsum(dz)
    (script/resampling_MAS_LOS.py:141-146). Returns (z in R_sun, dz)."""
    if dz0 > 1.0:
        raise ValueError(
            f"dz0={dz0:g} is extremely large in R_sun units. "
            "Did you mean something like 7e-4 instead of 7e4?"
        )
    idx = np.arange(n_z)
    dz = dz0 * (1.0 + (5.0 * idx / n_z) ** 2.5)
    return np.cumsum(dz), dz


def linear_z_grid(n_z: int, z_range=(0.0, 4.0)) -> tuple[np.ndarray, np.ndarray]:
    """Linear LOS z-grid (script/resampling_MAS_LOS.py:147-154)."""
    z = np.linspace(z_range[0], z_range[1], n_z)
    return z, np.abs(np.diff(z, prepend=z[0]))
