"""MAS coronal model loading, unit conversion and resampling, in torch.

A self-contained reader (mas/hdf4.py, or h5py for .h5 files) and a
nonuniform trilinear interpolator in MAS spherical coordinates (phi
periodic, theta and r weights clamped to the mesh, r outside the mesh ->
NaN), as in raytracinggrff_tpu/mas/model.py; the interpolator and the cube
resample are ops/resample.py's (a CUDA kernel each on the card, the plain
torch version on the CPU). Only files named {var}\\d{3}.hdf (or
.h5/.hdf5) are used (build_rays.py:48-66).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import torch

from ..constants import MAS_UNITS
from ..grids import UniformGrid
from ..ops import resample
from .hdf4 import read_hdf4_sds, write_hdf4_sds


def _identify_axes(shape, scales):
    """Map the 3 dimension scales to (phi, theta, r) axis indices by their
    value ranges: r >= ~0.9 R_sun past 1; theta within [0, pi]; phi within
    [0, 2pi] with max > pi."""
    cand = {"r": None, "theta": None, "phi": None}
    for i, s in enumerate(scales):
        if s is None:
            raise ValueError("MAS dataset missing a dimension scale")
        s = np.asarray(s, np.float64)
        smin, smax = float(s.min()), float(s.max())
        if smin >= 0.8 and smax > 1.001 and smax < 100.0:
            cand["r"] = i
        elif smax <= np.pi + 1e-6:
            cand["theta"] = i
        elif smax <= 2 * np.pi + 1e-6:
            cand["phi"] = i
    if None in cand.values():
        raise ValueError(
            f"could not identify (phi, theta, r) axes from scales "
            f"(shape={shape}, ranges="
            f"{[(float(np.min(s)), float(np.max(s))) for s in scales]})")
    return cand["phi"], cand["theta"], cand["r"]


class MASVariable:
    """One MAS field in physical units on its native spherical mesh, held
    as float64 numpy with the phi axis padded periodically."""

    def __init__(self, name, data, phi, theta, r, unit_factor=None):
        if unit_factor is None:
            unit_factor = MAS_UNITS.get(name, 1.0)
        self.name = name
        data = np.asarray(data, np.float64) * unit_factor
        phi = np.asarray(phi, np.float64)
        self.phi = np.concatenate([phi, [phi[0] + 2 * np.pi]])
        self.theta = np.asarray(theta, np.float64)
        self.r = np.asarray(r, np.float64)
        self.data = np.concatenate([data, data[:1]], axis=0)

    @classmethod
    def from_file(cls, path, name):
        path = Path(path)
        if path.suffix in (".h5", ".hdf5"):
            import h5py
            with h5py.File(path, "r") as f:
                key = "Data" if "Data" in f else list(f.keys())[0]
                data = np.asarray(f[key])
                scales = []
                for i in range(3):
                    dn = f"dim{i+1}"
                    scales.append(np.asarray(f[dn]) if dn in f else None)
                if any(s is None for s in scales):
                    scales = [np.asarray(f[key].dims[i][0])
                              if f[key].dims[i] else None for i in range(3)]
        else:
            sds = read_hdf4_sds(path)[0]
            data, scales = sds.data, sds.scales
        ip, it, ir = _identify_axes(data.shape, scales)
        data = np.transpose(data, (ip, it, ir))
        return cls(name, data, scales[ip], scales[it], scales[ir])

    def device_arrays(self, device, dtype=torch.float32):
        """(data, phi, theta, r) as `dtype` tensors on `device`."""
        return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (self.data, self.phi, self.theta, self.r))

    def sample_sph(self, r_q, colat_q, phi_q, device="cuda"):
        """Trilinear sample at spherical coordinates (arrays or tensors,
        broadcast to one shape; r in R_sun, angles in radians) as a float32
        tensor on `device`: phi periodic, theta clamped to the mesh, r
        outside the mesh -> NaN (the reference masks r < R_MIN before
        sampling anyway, build_rays.py:96); ops/resample.sample_sph, one
        kernel launch on a card."""
        def q(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        queries = torch.broadcast_tensors(q(r_q), q(colat_q), q(phi_q))
        return resample.sample_sph(*self.device_arrays(device),
                                   *(a.contiguous() for a in queries))

    def sample_at_coords(self, lon_deg, lat_deg, r_rsun, device="cuda"):
        """psipy-compatible signature: longitude and latitude in degrees,
        radius in R_sun (script/resampling_MAS_LOS.py:254-263). The unit
        conversion the reference applies with astropy is already in
        self.data."""
        lon = np.deg2rad(np.asarray(lon_deg))
        colat = np.pi / 2 - np.deg2rad(np.asarray(lat_deg))
        return self.sample_sph(r_rsun, colat, lon, device=device)


class MASModel:
    """MAS model directory with lazy per-variable loading
    (load_mas_var_filtered, build_rays.py:48-66). The reference
    concatenates a multi-timestep directory along a time axis and then
    samples one step; here time is an explicit index instead: `timestep`
    selects which {var}NNN file each variable loads (default: first),
    `n_timesteps` counts them, and `at_time(i)` gives a view of the same
    directory at another step, to iterate a time series."""

    def __init__(self, path, timestep=0):
        self.path = Path(path)
        if not self.path.is_dir():
            raise FileNotFoundError(f"MAS model directory not found: {path}")
        self.timestep = int(timestep)
        self._cache = {}

    @property
    def variables(self):
        names = set()
        for f in self.path.iterdir():
            m = re.match(r"^([a-z]+)\d{3}\.(hdf|h5|hdf5)$", f.name)
            if m:
                names.add(m.group(1))
        return sorted(names)

    def files_for(self, var_name):
        pattern = re.compile(rf"^{var_name}\d{{3}}\.(hdf|h5|hdf5)$")
        return sorted(f for f in self.path.iterdir() if pattern.match(f.name))

    def n_timesteps(self, var_name) -> int:
        return len(self.files_for(var_name))

    def at_time(self, timestep) -> "MASModel":
        """View of the same directory at another timestep (lazy, own
        cache)."""
        return MASModel(self.path, timestep=timestep)

    def __getitem__(self, var_name) -> MASVariable:
        key = (var_name, self.timestep)
        if key not in self._cache:
            files = self.files_for(var_name)
            if not files:
                raise KeyError(f"MAS variable {var_name!r} not found "
                               f"in {self.path}")
            if not 0 <= self.timestep < len(files):
                raise IndexError(
                    f"timestep {self.timestep} out of range: {var_name} "
                    f"has {len(files)} timestep file(s)")
            self._cache[key] = MASVariable.from_file(
                files[self.timestep], var_name)
        return self._cache[key]

    def temperature_variable(self):
        """'te' preferred over 't' (resample_with_ray_tracing.py:254-259)."""
        for v in ("te", "t"):
            if v in self.variables:
                return v
        raise ValueError("No electron temperature variable (te or t) found.")


def load_mas_var(model: MASModel, var_name: str) -> MASVariable:
    """One variable of a MAS model directory (load_mas_var_filtered,
    build_rays.py:48-66)."""
    return model[var_name]


def scene_arrays(variables, device):
    """MASVariable.device_arrays of each of `variables` (data, phi, theta,
    r), with an axis equal (np.array_equal) to one of an earlier variable
    uploaded once and shared, as the same tensor: ops/resample's kernels
    locate once on an axis that variables share."""
    uploaded = {"phi": [], "theta": [], "r": []}

    def axis(kind, a):
        for b, tensor in uploaded[kind]:
            if np.array_equal(a, b):
                return tensor
        tensor = torch.as_tensor(a, dtype=torch.float32, device=device)
        uploaded[kind].append((a, tensor))
        return tensor

    return [(torch.as_tensor(v.data, dtype=torch.float32, device=device),
             *(axis(kind, getattr(v, kind)) for kind in uploaded))
            for v in variables]


def resample_var_to_cube(var: MASVariable, grid: UniformGrid,
                         phi0_offset_deg=0.0, fill_nan=0.0, device="cuda",
                         chunk=16):
    """Resample a MAS variable onto the uniform cube with the reference's
    orientation cart_to_sph(x, -z, y, phi0) and the r >= R_MIN mask
    (build_rays.py:69-125): on a card one kernel launch
    (ops/resample.resample_cube), on the CPU the plain version in x-slabs
    of `chunk` planes to bound the transient memory. fill_nan=None keeps
    NaN. Returns an (nx, ny, nz) float32 tensor on `device`."""
    xs, ys, zs = (torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in grid.axes())
    return resample.resample_cube(*var.device_arrays(device), xs, ys, zs,
                                  phi0_offset_deg, fill_nan, chunk)


def synthetic_mas_model(path, nphi=64, ntheta=55, nr=60, r_max=6.0,
                        b0_gauss=2.5, modulated=True, timestep=2):
    """Write a synthetic MAS model (rho/t/br/bt/bp HDF4 files) for tests
    and demos: Newkirk-like density n_e(r) = 4.2e4 * 10^(4.32/r) cm^-3,
    optionally modulated by (1 + 0.3 cos(2 phi) sin^2 theta), a ~1.4 MK
    corona and a dipole field."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    phi = np.linspace(0, 2 * np.pi, nphi, endpoint=False)
    theta = np.linspace(0.02, np.pi - 0.02, ntheta)
    r = 1.0 + (r_max - 1.0) * (np.linspace(0, 1, nr) ** 1.5)

    P, T, R = np.meshgrid(phi, theta, r, indexing="ij")
    ne = 4.2e4 * 10 ** (4.32 / R)
    if modulated:
        ne = ne * (1.0 + 0.3 * np.cos(2 * P) * np.sin(T) ** 2)
    te = 1.4e6 * (1.0 - 0.25 * np.exp(-(R - 1.0) / 0.3)) * np.ones_like(ne)
    br = 2 * b0_gauss * np.cos(T) / R ** 3
    bt = b0_gauss * np.sin(T) / R ** 3
    bp = 0.1 * b0_gauss * np.sin(T) / R ** 3

    fields = {
        "rho": ne / MAS_UNITS["rho"],
        "t": te / MAS_UNITS["t"],
        "br": br / MAS_UNITS["br"],
        "bt": bt / MAS_UNITS["bt"],
        "bp": bp / MAS_UNITS["bp"],
    }
    for name, cube in fields.items():
        write_hdf4_sds(path / f"{name}{timestep:03d}.hdf",
                       cube.astype(np.float32), scales=[phi, theta, r],
                       label=name)
    return path
