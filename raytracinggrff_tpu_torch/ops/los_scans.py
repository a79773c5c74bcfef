"""The scans along lines of sight: the wrappers of csrc/los_scans.cu and
their plain versions.

  * valid_ds: the validity mask and ds of records pos (n_rec, n_rays, 3)
    and s (n_rec, n_rays), scanned from the ray starts (n_rays, 3): a
    record is valid where its position and s are finite, s > 0 and, with a
    `usable` mask, where that holds; its ds is the distance from the ray's
    last valid position in cm, 0 where it is not valid (record_step). It
    replaces the ds scans of the JAX package's sampler.py
    (sample_model_with_rays :78-85, los_from_records :144-152).
  * dem_scan: GET_MW's DEM-mode recurrence over the (2 modes, Nz, Nf)
    opacities tau, sources src and evanescent flags evan and the (Nz,)
    voxel validity m that grff/transfer._grff_transfer_dem builds:
    f <- f exp(-tau) + [m] src (-expm1(-tau)), and an evanescent voxel
    sets f = 0 and sum(tau) = inf. It replaces the voxel scan of
    _grff_transfer_dem_jit (raytracinggrff_tpu/grff/transfer.py:425-441).

In JAX each is a lax.scan inside a jitted program. Here each has a
hand-written CUDA kernel and a plain version that loops over records or
voxels in torch. Dispatch is by device, as for the other kernels: CPU
tensors run the plain version; CUDA tensors launch the kernel or raise.
LAUNCHES counts the launches of each ('valid_ds', 'dem').
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import R_SUN_CM
from . import _build
from ._build import _DemParams, _ScanParams

# kernel launches of each scan, counted where the kernel is launched
LAUNCHES = {"valid_ds": 0, "dem": 0}


def record_step(pos, s, prev, scale, usable=None):
    """One step of the ds scan: pos (n_rays, 3) and s (n_rays,) of a
    record, prev (n_rays, 3) the last valid positions, scale R_sun in cm.
    A record is valid where pos and s are finite, s > 0 and `usable` (if
    given) holds. Returns (valid, ds, the new last valid positions)."""
    valid = (torch.all(torch.isfinite(pos), dim=-1)
             & torch.isfinite(s) & (s > 0.0))
    if usable is not None:
        valid = valid & usable
    p_safe = torch.where(valid[:, None], pos, prev)
    d = torch.sqrt(torch.sum((p_safe - prev) ** 2, dim=-1)) * scale
    return valid, torch.where(valid, d, 0.0), p_safe


def valid_ds_plain(pos, s, ray_start, r_sun_cm=R_SUN_CM, usable=None):
    """valid_ds in plain torch, one record_step a record, on any device."""
    scale = torch.tensor(r_sun_cm, dtype=torch.float32, device=pos.device)
    prev = ray_start
    valid = torch.empty_like(s, dtype=torch.bool)
    ds = torch.empty_like(s)
    for i in range(pos.shape[0]):
        valid[i], ds[i], prev = record_step(
            pos[i], s[i], prev, scale, None if usable is None else usable[i])
    return valid, ds


def _check(device, named):
    """Refuse what the kernels do not take: `named` (name, tensor, dtype)
    triples of another dtype, not contiguous or off the CUDA `device`."""
    if device.type != "cuda":
        raise ValueError(f"no line-of-sight scan kernel for {device}")
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the kernel on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def valid_ds(pos, s, ray_start, r_sun_cm=R_SUN_CM, usable=None):
    """The validity mask (bool) and ds (float32, cm) of records pos
    (n_rec, n_rays, 3) and s (n_rec, n_rays), scanned from ray_start
    (n_rays, 3), with an optional bool `usable` (n_rec, n_rays). CPU
    tensors run valid_ds_plain; CUDA tensors launch the kernel, which takes
    float32 tensors, contiguous, on one device."""
    device = pos.device
    if device.type == "cpu":
        return valid_ds_plain(pos, s, ray_start, r_sun_cm, usable)
    f32 = torch.float32
    named = [("pos", pos, f32), ("s", s, f32), ("ray_start", ray_start, f32)]
    if usable is not None:
        named.append(("usable", usable, torch.bool))
    _check(device, named)
    if pos.dim() != 3 or pos.shape[2] != 3:
        raise ValueError(f"pos must be (n_rec, n_rays, 3), got "
                         f"{tuple(pos.shape)}")
    n_rec, n = pos.shape[:2]
    if tuple(s.shape) != (n_rec, n) or tuple(ray_start.shape) != (n, 3) or (
            usable is not None and tuple(usable.shape) != (n_rec, n)):
        raise ValueError(
            f"s{'' if usable is None else ' and usable'} must be ({n_rec}, "
            f"{n}) and ray_start ({n}, 3), got s {tuple(s.shape)}, "
            f"ray_start {tuple(ray_start.shape)}"
            + ("" if usable is None else f", usable {tuple(usable.shape)}"))
    if n_rec >= 2 ** 31:
        raise ValueError(f"{n_rec} records exceed the kernel's loop")
    valid = torch.empty((n_rec, n), dtype=torch.bool, device=device)
    ds = torch.empty((n_rec, n), dtype=f32, device=device)
    params = _ScanParams(n_rays=n, n_rec=n_rec,
                         scale=float(np.float32(r_sun_cm)))
    _build.launch("rgrff_valid_ds", device, pos.data_ptr(), s.data_ptr(),
                  ray_start.data_ptr(),
                  None if usable is None else usable.data_ptr(),
                  valid.data_ptr(), ds.data_ptr(), ctypes.byref(params))
    LAUNCHES["valid_ds"] += 1
    return valid, ds


def dem_scan_plain(tau, src, evan, m):
    """dem_scan in plain torch, voxel by voxel, on any device."""
    out = []
    for tau_m, src_m, evan_m in zip(tau, src, evan):
        f = torch.zeros(tau.shape[2], dtype=torch.float32, device=tau.device)
        t_sum = torch.zeros_like(f)
        for k in range(tau.shape[1]):
            f = f * torch.exp(-tau_m[k]) + torch.where(
                m[k], src_m[k] * -torch.expm1(-tau_m[k]), 0.0)
            f = torch.where(evan_m[k], 0.0, f)
            t_sum = torch.where(evan_m[k], torch.inf, t_sum + tau_m[k])
        out.append(torch.stack([f, t_sum]))
    return torch.stack(out)


def dem_scan(tau, src, evan, m):
    """The DEM-mode recurrence of both modes: tau and src (2, Nz, Nf)
    float32, evan (2, Nz, Nf) and m (Nz,) bool, on one device. Returns
    (2, 2, Nf) float32: [mode] (flux, total optical depth). CPU tensors
    run dem_scan_plain; CUDA tensors launch the kernel, which takes them
    contiguous."""
    device = tau.device
    if device.type == "cpu":
        return dem_scan_plain(tau, src, evan, m)
    f32, b8 = torch.float32, torch.bool
    _check(device, [("tau", tau, f32), ("src", src, f32),
                    ("evan", evan, b8), ("m", m, b8)])
    if tau.dim() != 3 or tau.shape[0] != 2:
        raise ValueError(f"tau must be (2, Nz, Nf), got {tuple(tau.shape)}")
    nz, nf = tau.shape[1:]
    if src.shape != tau.shape or evan.shape != tau.shape or \
            tuple(m.shape) != (nz,):
        raise ValueError(f"src and evan must be {tuple(tau.shape)} and m "
                         f"({nz},), got {tuple(src.shape)}, "
                         f"{tuple(evan.shape)}, {tuple(m.shape)}")
    if nf > 2 ** 29 or nz >= 2 ** 31:
        raise ValueError(f"{nz} voxels x {nf} frequencies exceed the "
                         f"kernel's grid")
    out = torch.empty((2, 2, nf), dtype=f32, device=device)
    params = _DemParams(nz=nz, nf=nf)
    _build.launch("rgrff_dem_scan", device, tau.data_ptr(), src.data_ptr(),
                  evan.data_ptr(), m.data_ptr(), out.data_ptr(),
                  ctypes.byref(params))
    LAUNCHES["dem"] += 1
    return out
