"""Spherical resampling of MAS variables: the wrappers of
csrc/resample_sph.cu and their plain versions.

A MAS variable is an (nphi + 1, ntheta, nr) array on its nonuniform (phi,
theta, r) mesh, the phi axis padded with its periodic copy
(mas/model.MASVariable). Its trilinear sample takes phi modulo 2 pi,
clamps the theta and r fractions to the mesh and gives NaN where r lies off
the mesh:

  * resample_cube samples it at the nodes of a uniform (nx, ny, nz) cube,
    given by its three axes, with the reference's orientation
    cart_to_sph(x, -z, y, phi0) and the r >= R_MIN mask, then fills the
    non-finite values unless fill_nan is None. It replaces the JAX
    package's _resample_cube_jit (raytracinggrff_tpu/mas/model.py:259-301).
  * sample_sph samples it at query points (r, colat, lon). It replaces
    _interp_sph_jit (raytracinggrff_tpu/mas/model.py:133-135).

In JAX each is one jitted device program. Here each has a hand-written
CUDA kernel, one thread a voxel or point, and a plain torch version.
Dispatch is by device, as for the other kernels: CPU tensors run the plain
version; CUDA tensors launch the kernel or raise. LAUNCHES counts the
launches of each ('cube', 'sph').
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..constants import R_MIN
from ..coords import image_xyz_to_mas_sph
from . import _build
from ._build import _SphParams

# kernel launches of each entry, counted where the kernel is launched
LAUNCHES = {"cube": 0, "sph": 0}


def _axis_locate(ax, q):
    """Cell index and clamped fraction on a 1D ascending nonuniform axis."""
    n = ax.shape[0]
    i = torch.clamp(torch.searchsorted(ax, q, right=True) - 1, 0, n - 2)
    t = (q - ax[i]) / (ax[i + 1] - ax[i])
    return i, torch.clamp(t, 0.0, 1.0)


def sample_sph_plain(data, phi, theta, r, r_q, colat_q, phi_q):
    """Trilinear sample of data (nphi+1, ntheta, nr) at spherical query
    tensors of any shape; phi is periodic, r outside the mesh gives NaN."""
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


def resample_cube_plain(data, phi, theta, r_ax, xs, ys, zs,
                        phi0_offset_deg=0.0, fill_nan=0.0, chunk=16):
    """resample_cube in plain torch, in x-slabs of `chunk` planes to bound
    the transient memory."""
    f32 = torch.float32
    phi0 = torch.tensor(phi0_offset_deg, dtype=f32)
    nx, ny, nz = xs.shape[0], ys.shape[0], zs.shape[0]
    out = torch.empty((nx, ny, nz), dtype=f32, device=data.device)
    for x0 in range(0, nx, chunk):
        xsl = xs[x0:x0 + chunk]
        shape = (xsl.shape[0], ny, nz)
        x = xsl[:, None, None].expand(shape)
        y = ys[None, :, None].expand(shape)
        z = zs[None, None, :].expand(shape)
        r, colat, lon = image_xyz_to_mas_sph(x, y, z, phi0)
        vals = sample_sph_plain(data, phi, theta, r_ax, r, colat, lon)
        vals = torch.where(r >= R_MIN, vals, math.nan)
        if fill_nan is not None:
            vals = torch.where(torch.isfinite(vals), vals, float(fill_nan))
        out[x0:x0 + chunk] = vals
    return out


def _check(device, named, data, phi, theta, r):
    """Refuse what the kernels do not take: `named` (name, tensor) pairs
    and the mesh not float32, contiguous and on the CUDA `device`, or a
    mesh whose array does not match its axes. Returns the mesh's
    (nphi, ntheta, nr)."""
    if device.type != "cuda":
        raise ValueError(f"no resampling kernel for {device}")
    mesh = [("data", data), ("phi", phi), ("theta", theta), ("r", r)]
    for name, t in mesh + list(named):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the kernel on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    sizes = tuple(a.shape[0] if a.dim() == 1 else -1
                  for a in (phi, theta, r))
    if tuple(data.shape) != sizes or min(sizes) < 2:
        raise ValueError(f"data {tuple(data.shape)} must be (nphi, ntheta, "
                         f"nr) of its 1D axes, each >= 2 nodes, got axes "
                         f"{[tuple(a.shape) for a in (phi, theta, r)]}")
    return sizes


def _lon_offset(phi0_offset_deg):
    """phi0 pi / 180 as coords.cart_to_sph computes it from the float32
    phi0 tensor of resample_cube_plain, by the same CPU ops."""
    phi0 = torch.tensor(phi0_offset_deg, dtype=torch.float32)
    return float(phi0 * math.pi / 180.0)


def resample_cube(data, phi, theta, r_ax, xs, ys, zs, phi0_offset_deg=0.0,
                  fill_nan=0.0, chunk=16):
    """Resample the MAS array data (nphi+1, ntheta, nr) on its axes phi,
    theta, r_ax onto the uniform cube of axes xs, ys, zs (float32 tensors
    on one device): cart_to_sph(x, -z, y, phi0_offset_deg), NaN where r <
    R_MIN, non-finite values replaced by fill_nan unless it is None.
    Returns an (nx, ny, nz) float32 tensor. CPU tensors run
    resample_cube_plain (in x-slabs of `chunk` planes); CUDA tensors launch
    the kernel, one launch a cube."""
    device = data.device
    if device.type == "cpu":
        return resample_cube_plain(data, phi, theta, r_ax, xs, ys, zs,
                                   phi0_offset_deg, fill_nan, chunk)
    axes = [("xs", xs), ("ys", ys), ("zs", zs)]
    nphi, ntheta, nr = _check(device, axes, data, phi, theta, r_ax)
    if any(a.dim() != 1 for _, a in axes):
        raise ValueError("xs, ys and zs must be 1D")
    nx, ny, nz = (a.shape[0] for _, a in axes)
    if max(nx, ny) > 65535:
        raise ValueError(f"a {nx} x {ny} cube exceeds the kernel's grid")
    out = torch.empty((nx, ny, nz), dtype=torch.float32, device=device)
    params = _SphParams(
        n=0, nphi=nphi, ntheta=ntheta, nr=nr, nx=nx, ny=ny, nz=nz,
        fill_on=int(fill_nan is not None),
        lon_offset=_lon_offset(phi0_offset_deg),
        r_min=float(np.float32(R_MIN)),
        fill=0.0 if fill_nan is None else float(fill_nan))
    _build.launch("rgrff_resample_cube", device, data.data_ptr(),
                  phi.data_ptr(), theta.data_ptr(), r_ax.data_ptr(),
                  xs.data_ptr(), ys.data_ptr(), zs.data_ptr(),
                  out.data_ptr(), ctypes.byref(params))
    LAUNCHES["cube"] += 1
    return out


def sample_sph(data, phi, theta, r, r_q, colat_q, phi_q):
    """Trilinear sample of the MAS array data (nphi+1, ntheta, nr) on its
    axes phi, theta, r at the query points r_q (R_sun), colat_q and phi_q
    (radians), float32 tensors on one device: phi periodic, theta clamped
    to the mesh, r off the mesh -> NaN. CPU tensors run sample_sph_plain,
    which broadcasts the queries; CUDA tensors launch the kernel, which
    takes three contiguous queries of one shape. Returns their shape."""
    device = data.device
    if device.type == "cpu":
        return sample_sph_plain(data, phi, theta, r, r_q, colat_q, phi_q)
    queries = [("r_q", r_q), ("colat_q", colat_q), ("phi_q", phi_q)]
    nphi, ntheta, nr = _check(device, queries, data, phi, theta, r)
    if not r_q.shape == colat_q.shape == phi_q.shape:
        raise ValueError(f"queries must share one shape, got "
                         f"{[tuple(q.shape) for _, q in queries]}")
    out = torch.empty_like(r_q)
    params = _SphParams(n=r_q.numel(), nphi=nphi, ntheta=ntheta, nr=nr)
    _build.launch("rgrff_sample_sph", device, data.data_ptr(),
                  phi.data_ptr(), theta.data_ptr(), r.data_ptr(),
                  r_q.data_ptr(), colat_q.data_ptr(), phi_q.data_ptr(),
                  out.data_ptr(), ctypes.byref(params))
    LAUNCHES["sph"] += 1
    return out
