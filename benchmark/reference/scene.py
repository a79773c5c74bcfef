"""The plain reference of scene preparation: from the MAS arrays and mesh
that the benchmark generated to the pipeline cubes and the ray starts.

Frozen copies, in plain torch, of what the program derives in its set-up
and timed path: MASVariable's unit conversion and periodic phi padding
(raytracinggrff_tpu_torch/mas/model.py), UniformGrid.cube and axes
(grids.py), cart_to_sph(x, -z, y, phi0) (coords.py), the plain cube
resample resample_cube_plain with sample_sph_plain (ops/resample.py),
_finalize_cubes and image_ray_starts (pipeline.py). Every function takes
the dtype it computes in: float32 as the configurations state, or a lower
precision for the control.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .constants import FPE_COEF, MAS_UNITS, R_MIN


@dataclasses.dataclass(frozen=True)
class Grid:
    """A symmetric uniform cube, as UniformGrid.cube builds it."""

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
    def cube(cls, extent, n):
        g = np.linspace(-extent, extent, int(n))
        step = float(np.mean(np.diff(g)))
        return cls(float(g[0]), float(g[0]), float(g[0]), step, step, step,
                   int(n), int(n), int(n))

    @property
    def inv_steps(self):
        return (1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz)

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    def axes(self):
        """Host-side coordinate arrays (float64)."""
        return (self.x0 + self.dx * np.arange(self.nx),
                self.y0 + self.dy * np.arange(self.ny),
                self.z0 + self.dz * np.arange(self.nz))


def mas_variable(data, mesh, name):
    """(data, phi, theta, r) float64 numpy of one MAS field: physical
    units, the phi axis padded with its periodic copy."""
    phi, theta, r = (np.asarray(a, np.float64) for a in mesh)
    data = np.asarray(data, np.float64) * MAS_UNITS[name]
    return (np.concatenate([data, data[:1]], axis=0),
            np.concatenate([phi, [phi[0] + 2 * np.pi]]), theta, r)


def _axis_locate(ax, q):
    """Cell index and clamped fraction on a 1D ascending nonuniform axis."""
    n = ax.shape[0]
    i = torch.clamp(torch.searchsorted(ax, q, right=True) - 1, 0, n - 2)
    t = (q - ax[i]) / (ax[i + 1] - ax[i])
    return i, torch.clamp(t, 0.0, 1.0)


def sample_sph(data, phi, theta, r, r_q, colat_q, phi_q):
    """Trilinear sample of data (nphi+1, ntheta, nr) at spherical queries;
    phi is periodic, r outside the mesh gives NaN."""
    r_q, colat_q, phi_q = torch.broadcast_tensors(r_q, colat_q, phi_q)
    shape = r_q.shape
    phi_q = torch.remainder(phi_q, 2 * math.pi).reshape(-1)
    r_q = r_q.reshape(-1)
    colat_q = colat_q.reshape(-1)

    ip, tp = _axis_locate(phi, phi_q)
    it, tt = _axis_locate(theta, colat_q)
    ir, tr = _axis_locate(r, r_q)

    oob = (r_q < r[0] - 1e-9) | (r_q > r[-1] + 1e-9) | ~torch.isfinite(r_q)

    ntheta, nr = data.shape[1], data.shape[2]
    flat = data.reshape(-1)
    base = (ip * ntheta + it) * nr + ir

    def take(off):
        return flat[base + off]

    sp = ntheta * nr
    st = nr
    c00 = take(0) * (1 - tp) + take(sp) * tp
    c10 = take(st) * (1 - tp) + take(sp + st) * tp
    c01 = take(1) * (1 - tp) + take(sp + 1) * tp
    c11 = take(st + 1) * (1 - tp) + take(sp + st + 1) * tp
    c0 = c00 * (1 - tt) + c10 * tt
    c1 = c01 * (1 - tt) + c11 * tt
    v = c0 * (1 - tr) + c1 * tr
    return torch.where(oob, math.nan, v).reshape(shape)


def cart_to_sph(x, y, z, phi0_offset_deg=0.0):
    """Cartesian tensors -> (r, colatitude, longitude in [0, 2pi))."""
    r = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    colat = torch.arccos(torch.clamp(z / r, -1.0, 1.0))
    lon = torch.arctan2(y, x)
    lon = lon + phi0_offset_deg * math.pi / 180.0
    lon = torch.where(lon < 0, lon + 2.0 * math.pi, lon)
    return r, colat, lon


def resample_cube(data, phi, theta, r_ax, xs, ys, zs, phi0_offset_deg,
                  dtype, chunk=16):
    """One variable resampled onto the cube of axes xs, ys, zs with the
    orientation cart_to_sph(x, -z, y, phi0) and NaN where r < R_MIN, in
    x-slabs of `chunk` planes."""
    phi0 = torch.tensor(phi0_offset_deg, dtype=dtype)
    nx, ny, nz = xs.shape[0], ys.shape[0], zs.shape[0]
    out = torch.empty((nx, ny, nz), dtype=dtype, device=data.device)
    for x0 in range(0, nx, chunk):
        xsl = xs[x0:x0 + chunk]
        shape = (xsl.shape[0], ny, nz)
        x = xsl[:, None, None].expand(shape)
        y = ys[None, :, None].expand(shape)
        z = zs[None, None, :].expand(shape)
        r, colat, lon = cart_to_sph(x, -z, y, phi0)
        vals = sample_sph(data, phi, theta, r_ax, r, colat, lon)
        out[x0:x0 + chunk] = torch.where(r >= R_MIN, vals, math.nan)
    return out


def finalize_cubes(ne_raw, te_raw, br, bt, bp):
    """The post-resampling transforms: omega_pe, ne, te and |B| cubes."""
    ne_raw = torch.nan_to_num(ne_raw, nan=0.0)
    br = torch.nan_to_num(br, nan=0.0)
    bt = torch.nan_to_num(bt, nan=0.0)
    bp = torch.nan_to_num(bp, nan=0.0)
    ne = torch.clamp(ne_raw, min=0.0)
    omega_pe = FPE_COEF * torch.sqrt(ne) * (2.0 * math.pi)
    omega_pe = torch.nan_to_num(omega_pe, nan=0.0, posinf=0.0, neginf=0.0)
    te = torch.where(torch.isfinite(te_raw), te_raw, 1e4)
    b = torch.sqrt(br * br + bt * bt + bp * bp)
    return omega_pe, ne, te, b


def scene_cubes(arrays, mesh, grid, phi0_offset_deg, device, dtype):
    """{omega_pe, ne, te, b} cubes of the MAS fields `arrays` (code units,
    as generated) on `mesh`, resampled onto `grid`."""
    xs, ys, zs = (torch.as_tensor(a, dtype=dtype, device=device)
                  for a in grid.axes())
    raw = []
    for name in ("rho", "t", "br", "bt", "bp"):
        data, phi, theta, r = (torch.as_tensor(a, dtype=dtype, device=device)
                               for a in mas_variable(arrays[name], mesh,
                                                     name))
        raw.append(resample_cube(data, phi, theta, r, xs, ys, zs,
                                 phi0_offset_deg, dtype))
    omega_pe, ne, te, b = finalize_cubes(*raw)
    return {"omega_pe": omega_pe, "ne": ne, "te": te, "b": b}


def image_ray_starts(n_pix, x_fov, z_observer):
    """Image-plane ray starts and directions (float32 numpy): pixel
    p = i * n_pix + j starts at (x_j, y_i, z_start) and looks along -z."""
    xs = np.linspace(-x_fov, x_fov, n_pix)
    ys = np.linspace(-x_fov, x_fov, n_pix)
    X, Y = np.meshgrid(xs, ys)
    x_flat = X.ravel()
    y_flat = Y.ravel()
    z_start = np.sqrt(np.abs((z_observer * 2.0) ** 2
                             - x_flat ** 2 - y_flat ** 2)) / 2.0
    start = np.column_stack([x_flat, y_flat, z_start]).astype(np.float32)
    kdir = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (n_pix ** 2, 1))
    return xs, ys, start, kdir
