"""Spherical resampling of MAS variables: the wrappers of
csrc/resample_sph.cu and their plain versions.

A MAS variable is an (nphi + 1, ntheta, nr) array on its nonuniform (phi,
theta, r) mesh, the phi axis padded with its periodic copy
(mas/model.MASVariable). Its trilinear sample takes phi modulo 2 pi,
clamps the theta and r fractions to the mesh and gives NaN where r lies off
the mesh:

  * resample_cubes samples a scene of 1 to MAX_VARS variables, each given
    as its (data, phi, theta, r) tensors, at the nodes of a uniform (nx,
    ny, nz) cube, given by its three axes, with the reference's
    orientation cart_to_sph(x, -z, y, phi0) and the r >= R_MIN mask, then
    fills the non-finite values unless fill_nan is None: one cube a
    variable. It replaces the JAX package's _resample_cube_jit
    (raytracinggrff_tpu/mas/model.py:259-301), one call a variable;
    resample_cube is the same for one variable.
  * sample_sph_many samples a scene at query points (r, colat, lon), and
    sample_sph one variable. They replace _interp_sph_jit
    (raytracinggrff_tpu/mas/model.py:133-135).

In JAX each variable is one jitted device program. Here a scene is one
launch of a hand-written CUDA kernel, which computes each point's
coordinates and locates once for all variables, and once for the
variables that share an axis: the same tensor (mas/model.scene_arrays
uploads an axis once for the variables whose axes are equal). Each has a
plain torch version, one variable at a time. Dispatch is by device, as for
the other kernels: CPU tensors run the plain version; CUDA tensors launch
the kernel or raise. LAUNCHES counts the launches of each ('cube', 'sph'),
one a scene.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..constants import R_MIN
from ..coords import image_xyz_to_mas_sph
from . import _build
from ._build import MAX_VARS, _SphParams

# kernel launches of each entry, counted where the kernel is launched
LAUNCHES = {"cube": 0, "sph": 0}
# the shared memory a block of the kernels may use on an H100, which holds
# the scene's distinct axes
MAX_SHARED_BYTES = 232448


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


def sample_sph_many_plain(variables, r_q, colat_q, phi_q):
    """sample_sph_plain of each (data, phi, theta, r) of `variables` at the
    same queries: one tensor a variable."""
    return [sample_sph_plain(*v, r_q, colat_q, phi_q) for v in variables]


def resample_cubes_plain(variables, xs, ys, zs, phi0_offset_deg=0.0,
                         fill_nan=0.0, chunk=16):
    """resample_cube_plain of each (data, phi, theta, r) of `variables`
    onto the same cube: one cube a variable."""
    return [resample_cube_plain(*v, xs, ys, zs, phi0_offset_deg, fill_nan,
                                chunk) for v in variables]


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


def _scene_device(variables):
    """The device of a scene's tensors; refuses a scene of no variable."""
    if not variables:
        raise ValueError(f"a scene holds 1 to {MAX_VARS} variables, got 0")
    return variables[0][0].device


def _scene(device, named, variables):
    """_SphParams of a scene: each (data, phi, theta, r) of `variables`
    checked with the `named` tensors (_check), its array and sizes, and an
    id for each of its axes, the same for the same tensor (its memory: the
    same device address and length). Refuses more than MAX_VARS
    variables, and axes beyond the shared memory."""
    if len(variables) > MAX_VARS:
        raise ValueError(f"a scene holds 1 to {MAX_VARS} variables, got "
                         f"{len(variables)}")
    p = _SphParams(n_vars=len(variables))
    distinct = ([], [], [])
    for v, (data, *axes) in enumerate(variables):
        p.dims[v][:] = _check(device, named if v == 0 else (), data, *axes)
        p.data[v] = data.data_ptr()
        for k, ax in enumerate(axes):
            key = (ax.data_ptr(), ax.shape[0])
            if key not in distinct[k]:
                distinct[k].append(key)
            p.var_axis[v][k] = distinct[k].index(key)
    for k, keys in enumerate(distinct):
        p.n_axes[k] = len(keys)
        for a, (ptr, n) in enumerate(keys):
            p.axis[k][a], p.axis_len[k][a] = ptr, n
    nbytes = 4 * sum(n for keys in distinct for _, n in keys)
    if nbytes > MAX_SHARED_BYTES:
        raise ValueError(f"the scene's distinct axes take {nbytes} bytes, "
                         f"above the kernels' {MAX_SHARED_BYTES} bytes of "
                         f"shared memory")
    return p


def resample_cubes(variables, xs, ys, zs, phi0_offset_deg=0.0, fill_nan=0.0,
                   chunk=16):
    """Resample each MAS array data (nphi+1, ntheta, nr) of `variables`,
    (data, phi, theta, r_ax) tuples of 1 to MAX_VARS variables, each on its
    own axes, onto the uniform cube of axes xs, ys, zs (float32 tensors on
    one device): cart_to_sph(x, -z, y, phi0_offset_deg), NaN where r <
    R_MIN, non-finite values replaced by fill_nan unless it is None.
    Returns a list of (nx, ny, nz) float32 tensors, one a variable. CPU
    tensors run resample_cubes_plain (in x-slabs of `chunk` planes); CUDA
    tensors launch the kernel, one launch for the scene."""
    variables = list(variables)
    device = _scene_device(variables)
    if device.type == "cpu":
        return resample_cubes_plain(variables, xs, ys, zs, phi0_offset_deg,
                                    fill_nan, chunk)
    axes = [("xs", xs), ("ys", ys), ("zs", zs)]
    p = _scene(device, axes, variables)
    if any(a.dim() != 1 for _, a in axes):
        raise ValueError("xs, ys and zs must be 1D")
    nx, ny, nz = (a.shape[0] for _, a in axes)
    if nx > 65535:
        raise ValueError(f"a {nx} x {ny} cube exceeds the kernel's grid")
    outs = [torch.empty((nx, ny, nz), dtype=torch.float32, device=device)
            for _ in variables]
    for v, out in enumerate(outs):
        p.out[v] = out.data_ptr()
    p.nx, p.ny, p.nz = nx, ny, nz
    p.fill_on = int(fill_nan is not None)
    p.lon_offset = _lon_offset(phi0_offset_deg)
    p.r_min = float(np.float32(R_MIN))
    p.fill = 0.0 if fill_nan is None else float(fill_nan)
    _build.launch("rgrff_resample_cube", device, xs.data_ptr(),
                  ys.data_ptr(), zs.data_ptr(), ctypes.byref(p))
    LAUNCHES["cube"] += 1
    return outs


def resample_cube(data, phi, theta, r_ax, xs, ys, zs, phi0_offset_deg=0.0,
                  fill_nan=0.0, chunk=16):
    """Resample the MAS array data (nphi+1, ntheta, nr) on its axes phi,
    theta, r_ax onto the uniform cube of axes xs, ys, zs: resample_cubes of
    one variable. Returns an (nx, ny, nz) float32 tensor."""
    return resample_cubes([(data, phi, theta, r_ax)], xs, ys, zs,
                          phi0_offset_deg, fill_nan, chunk)[0]


def sample_sph_many(variables, r_q, colat_q, phi_q):
    """Trilinear sample of each MAS array data (nphi+1, ntheta, nr) of
    `variables`, (data, phi, theta, r) tuples of 1 to MAX_VARS variables,
    each on its own axes, at the query points r_q (R_sun), colat_q and
    phi_q (radians), float32 tensors on one device: phi periodic, theta
    clamped to the mesh, r off the mesh -> NaN. Returns a list of tensors
    of the queries' shape, one a variable. CPU tensors run
    sample_sph_many_plain, which broadcasts the queries; CUDA tensors
    launch the kernel once, which takes three contiguous queries of one
    shape."""
    variables = list(variables)
    device = _scene_device(variables)
    if device.type == "cpu":
        return sample_sph_many_plain(variables, r_q, colat_q, phi_q)
    queries = [("r_q", r_q), ("colat_q", colat_q), ("phi_q", phi_q)]
    p = _scene(device, queries, variables)
    if not r_q.shape == colat_q.shape == phi_q.shape:
        raise ValueError(f"queries must share one shape, got "
                         f"{[tuple(q.shape) for _, q in queries]}")
    outs = [torch.empty_like(r_q) for _ in variables]
    for v, out in enumerate(outs):
        p.out[v] = out.data_ptr()
    p.n = r_q.numel()
    _build.launch("rgrff_sample_sph", device, r_q.data_ptr(),
                  colat_q.data_ptr(), phi_q.data_ptr(), ctypes.byref(p))
    LAUNCHES["sph"] += 1
    return outs


def sample_sph(data, phi, theta, r, r_q, colat_q, phi_q):
    """Trilinear sample of the MAS array data (nphi+1, ntheta, nr) on its
    axes phi, theta, r at the query points r_q, colat_q and phi_q:
    sample_sph_many of one variable. Returns the queries' shape."""
    return sample_sph_many([(data, phi, theta, r)], r_q, colat_q, phi_q)[0]
