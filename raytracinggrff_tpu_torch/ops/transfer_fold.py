"""The transfer folds: their wrappers, plain versions and kernel parameters.

Both fold voxels into the two-mode transfer carry (flux_o, flux_x, tau_o,
tau_x), each (n_rays, Nf) float32, with the voxel update of
grff/transfer.make_voxel_update:

  * fold_records folds one trace segment's records (rps, 8, n_rays), rows
    [x, y, z, S, ne, te, b, cos_theta]. A record is valid where its
    position and S are finite and S > 0 (with theta_los also where row 7
    is finite), and its ds is the distance from the ray's last valid
    position in cm (los_scans.record_step); with s_on its source area is S
    times the pixel area, and with theta_los row 7 sets its theta. It
    replaces the JAX pipeline's per-segment scan stream_seg
    (raytracinggrff_tpu/pipeline.py:377-396).
  * fold_voxels folds (Nz, n_pix) voxel arrays that already hold ds, the
    validity and the source areas, with an optional per-voxel theta
    (radians) and mechanism mask (int32). It replaces _grff_transfer_jit
    (raytracinggrff_tpu/grff/transfer.py:231-275).
  * fold_counts counts what fold_records does with a segment's records:
    the records it steps from (valid) and those it takes (valid, with
    finite ne, te, b and ds, ds > 0), for the fold's roofline. It is a
    kernel of its own, launched only where a caller counts, so that the
    fold is the same whether or not anything counts.

In JAX both are XLA scans. Here each has a hand-written CUDA kernel
(csrc/transfer_fold.cu: a group of group_size(Nf, n_rays) lanes a ray,
one record and one frequency's carry a lane, that computes each record's
frequency-free terms once; the carry in registers across the call) and a
plain version that loops over records or voxels in torch. Dispatch is by
device, as for ops/trace_segment: CPU tensors run the plain version; CUDA
tensors launch the kernel or raise. LAUNCHES counts the kernel launches of
each fold ('records', 'voxels') and of the counts ('counts').
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..constants import (AU_CM, C_CGS, FB_COEF, FPE_COEF, KB_CGS, M_E_G,
                         R_SUN_CM, SFU2CGS)
from ..grff import physics
from ..grff.transfer import (MECH_FREEFREE, MECH_GYRORESONANCE,
                             MECH_NEUTRALS, make_voxel_update,
                             transfer_carry_init)
from . import _build
from ._build import _FoldParams, _harmonic_tables
from .los_scans import record_step

RECORD_ROWS = 8
GAUNTS = ("dulk", "exact")
# kernel launches of each fold, counted where the kernel is launched
LAUNCHES = {"records": 0, "voxels": 0, "counts": 0}
# lanes a launch should keep busy: 2,048 warps, about 16 a SM of an H100;
# with fewer, group_size gives a ray more lanes (csrc/transfer_fold.cu)
FILL_LANES = 65536


def group_size(nf, n_rays):
    """Lanes a ray in the kernels: the next power of two >= min(nf, 8),
    doubled (up to 8) while n_rays rays in ceil(nf / G) frequency groups
    hold fewer than FILL_LANES lanes."""
    nf, n_rays = int(nf), int(n_rays)
    g = 1 << max(min(nf, 8) - 1, 0).bit_length()
    while g < 8 and n_rays * g * -(-nf // g) < FILL_LANES:
        g *= 2
    return g


@functools.cache
def _tables(device, s_max):
    """_harmonic_tables(s_max) as a tensor on `device`, made once."""
    return torch.as_tensor(_harmonic_tables(s_max), device=device)


def _tables_ptr(device, mechanism, s_max):
    """The harmonic tables' device pointer for a fold that sums harmonics,
    else None."""
    if not int(mechanism) & MECH_GYRORESONANCE:
        return None
    return _tables(device, int(s_max)).data_ptr()


def _inv(x):
    """1/x in float32 of float32 x: torch's CUDA division by a Python
    scalar multiplies by this."""
    return float(np.float32(1.0) / np.float32(x))


def fold_params(n_rays, nf, n_steps, pixel_area_cm2, theta_deg, mechanism,
                s_max, gaunt, theta_per_voxel, s_on=False):
    """The kernel's FoldParams: the call's settings and the physics
    constants of constants.py and grff/physics.py, as the float32 values
    the plain version's torch ops use, with group_size(nf, n_rays) lanes a
    ray."""
    inv_au = np.float32(1.0 / AU_CM)
    return _FoldParams(
        n_rays=n_rays, nf=nf, n_steps=n_steps, mechanism=int(mechanism) & 7,
        gaunt_exact=int(gaunt == "exact"), s_max=int(s_max),
        theta_per_voxel=int(bool(theta_per_voxel)), s_on=int(bool(s_on)),
        group=group_size(nf, n_rays),
        theta0=float(np.float32(np.deg2rad(theta_deg))),
        area=float(np.float32(pixel_area_cm2)),
        inv_au_sq=float(inv_au * inv_au), r_sun_cm=R_SUN_CM,
        src_coef=KB_CGS / (C_CGS * C_CGS) / SFU2CGS, fpe_sq=FPE_COEF ** 2,
        fb=FB_COEF, kappa_ff=physics.KAPPA_FF_COEF,
        kappa_ff_exact=physics.KAPPA_FF_EXACT_COEF,
        gaunt_cl=physics.GAUNT_CL_CONST, gaunt_born=physics.GAUNT_BORN_CONST,
        sqrt3_over_pi=physics.SQRT3_OVER_PI, saha=physics.SAHA_COEF,
        neg_chi=-physics.CHI_H_OVER_K, sigma_eh=physics.SIGMA_EH_CM2,
        vmean_num=8.0 * KB_CGS, inv_vmean_den=_inv(math.pi * M_E_G),
        c_cgs=C_CGS, kb=KB_CGS, inv_mec2=_inv(M_E_G * C_CGS * C_CGS),
        gr_pref=math.pi ** 2 / (2.0 * C_CGS),
        sqrt_2pi=math.sqrt(2.0 * math.pi))


def _check_tensors(device, named):
    """Refuse `named` (name, tensor, dtype) triples of another dtype, on
    another device than `device`, or not contiguous."""
    for name, t, dtype in named:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the fold on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_common(device, named, carry, n, freqs, gaunt):
    """Types, devices and contiguity shared by both folds: `named` (name,
    tensor, dtype) triples, freqs (Nf,) and the carry (four (n, Nf) float32
    tensors, or None). Returns Nf."""
    if gaunt not in GAUNTS:
        raise ValueError(f"gaunt must be one of {GAUNTS}, got {gaunt!r}")
    named = list(named) + [("freqs", freqs, torch.float32)]
    if carry is not None:
        if len(carry) != 4:
            raise ValueError(f"carry must hold 4 tensors, got {len(carry)}")
        named += [(f"carry[{i}]", c, torch.float32)
                  for i, c in enumerate(carry)]
    _check_tensors(device, named)
    if freqs.dim() != 1:
        raise ValueError(f"freqs must be (Nf,), got {tuple(freqs.shape)}")
    nf = freqs.shape[0]
    if carry is not None and any(tuple(c.shape) != (n, nf) for c in carry):
        raise ValueError(f"carry tensors must be ({n}, {nf}), got "
                         f"{[tuple(c.shape) for c in carry]}")
    return nf


def _kernel_device(device, n, nf):
    """Refuse what the kernel does not take: its grid's limits, rays
    without a frequency (the grid would be empty and leave the positions
    unfolded), a device other than CUDA."""
    if n >= 2 ** 31 or nf > 65535:
        raise ValueError(f"{n} rays x {nf} frequencies exceed the kernel's "
                         f"grid")
    if n > 0 and nf == 0:
        raise ValueError("the kernel folds at least one frequency")
    if device.type != "cuda":
        raise ValueError(f"no transfer-fold kernel for {device}")


def _launch(kind, device, *args):
    """Launch rgrff_fold_`kind` on the current stream of `device` and
    count it."""
    _build.launch(f"rgrff_fold_{kind}", device, *args)
    LAUNCHES[kind] += 1


def fold_records(recs, carry, prev, freqs, pixel_area_cm2, theta_deg=90.0,
                 mechanism=MECH_FREEFREE | MECH_NEUTRALS,
                 s_max=30, gaunt="dulk", s_on=False, theta_los=False):
    """Fold one segment's records `recs` (rps, 8, n_rays) into `carry`
    (flux_o, flux_x, tau_o, tau_x), each (n_rays, Nf), from the last valid
    positions `prev` (n_rays, 3), at `freqs` (Nf,); all float32 and
    contiguous on one device. theta_deg, mechanism, s_max and gaunt are
    those of make_voxel_update; s_on takes each record's source area as S
    times the pixel area; theta_los takes its theta from row 7's cos theta
    (a record whose row 7 is not finite is invalid). Returns (carry, prev)
    after the segment. CPU tensors run fold_records_plain; CUDA tensors
    launch the kernel."""
    device = recs.device
    if recs.dim() != 3 or recs.shape[1] != RECORD_ROWS:
        raise ValueError(f"recs must be (rps, {RECORD_ROWS}, n_rays), got "
                         f"{tuple(recs.shape)}")
    n = recs.shape[2]
    nf = _check_common(device, [("recs", recs, torch.float32),
                                ("prev", prev, torch.float32)],
                       carry, n, freqs, gaunt)
    if tuple(prev.shape) != (n, 3):
        raise ValueError(f"prev must be ({n}, 3), got {tuple(prev.shape)}")
    if device.type == "cpu":
        return fold_records_plain(recs, carry, prev, freqs, pixel_area_cm2,
                                  theta_deg, mechanism, s_max, gaunt, s_on,
                                  theta_los)
    _kernel_device(device, n, nf)
    if n == 0:
        return tuple(carry), prev
    out = torch.empty((4, n, nf), dtype=torch.float32, device=device)
    prev_out = torch.empty_like(prev)
    params = fold_params(n, nf, recs.shape[0], pixel_area_cm2, theta_deg,
                         mechanism, s_max, gaunt, theta_los, s_on)
    _launch("records", device, recs.data_ptr(), freqs.data_ptr(),
            _tables_ptr(device, mechanism, s_max),
            *(c.data_ptr() for c in carry), prev.data_ptr(), out.data_ptr(),
            prev_out.data_ptr(), ctypes.byref(params))
    return tuple(out.unbind(0)), prev_out


def fold_records_plain(recs, carry, prev, freqs, pixel_area_cm2,
                       theta_deg=90.0,
                       mechanism=MECH_FREEFREE | MECH_NEUTRALS,
                       s_max=30, gaunt="dulk", s_on=False, theta_los=False):
    """fold_records in plain torch, record by record, on any device: the
    ds/valid step of los_scans.record_step and make_voxel_update."""
    update = make_voxel_update(freqs, pixel_area_cm2, theta_deg, mechanism,
                               s_max, gaunt)
    area32 = np.float32(pixel_area_cm2)
    scale = np.float32(R_SUN_CM)
    for rec in recs:
        s = rec[3]
        valid, dsv, prev = record_step(
            rec[0:3].T, s, prev, scale,
            torch.isfinite(rec[7]) if theta_los else None)
        sarea = s * area32 if s_on else torch.zeros_like(s)
        theta_k = (torch.arccos(torch.clamp(rec[7], -1.0, 1.0))
                   if theta_los else None)
        carry = update(carry, dsv, rec[5], rec[4], rec[6], valid, sarea,
                       theta_k)
    return tuple(carry), prev.contiguous()


def fold_counts(recs, prev, counts, theta_los=False):
    """Add to `counts` ((2,) int64) the records of `recs` (rps, 8, n_rays)
    that fold_records steps from, from the last valid positions `prev`
    (n_rays, 3) it was given, and those it takes: valid by
    los_scans.record_step (with theta_los also where row 7 is finite), and
    taken where ne, te, b and ds are finite and ds > 0. CPU tensors count
    in plain torch; CUDA tensors launch the counting kernel."""
    device = recs.device
    if recs.dim() != 3 or recs.shape[1] != RECORD_ROWS:
        raise ValueError(f"recs must be (rps, {RECORD_ROWS}, n_rays), got "
                         f"{tuple(recs.shape)}")
    n = recs.shape[2]
    _check_tensors(device, [("recs", recs, torch.float32),
                            ("prev", prev, torch.float32),
                            ("counts", counts, torch.int64)])
    if tuple(prev.shape) != (n, 3) or tuple(counts.shape) != (2,):
        raise ValueError(f"prev must be ({n}, 3) and counts (2,), got "
                         f"{tuple(prev.shape)} and {tuple(counts.shape)}")
    if device.type == "cpu":
        counts += fold_counts_plain(recs, prev, theta_los)
        return
    _kernel_device(device, n, 1)
    # the fold's parameters that the count reads: rays, records, the ds
    # scale and whether row 7 decides validity
    params = fold_params(n, 1, recs.shape[0], 1.0, 90.0, MECH_FREEFREE, 0,
                         "dulk", theta_los)
    _launch("counts", device, recs.data_ptr(), prev.data_ptr(),
            counts.data_ptr(), ctypes.byref(params))


def fold_counts_plain(recs, prev, theta_los=False):
    """fold_counts in plain torch, record by record: [stepped from,
    taken] as an int64 tensor."""
    scale = np.float32(R_SUN_CM)
    out = torch.zeros(2, dtype=torch.int64, device=recs.device)
    for rec in recs:
        valid, ds, prev = record_step(
            rec[0:3].T, rec[3], prev, scale,
            torch.isfinite(rec[7]) if theta_los else None)
        taken = (valid & torch.isfinite(rec[4:7]).all(dim=0)
                 & torch.isfinite(ds) & (ds > 0))
        out += torch.stack([valid.sum(), taken.sum()])
    return out


def fold_voxels(ds, te, ne, b, valid, freqs, pixel_area_cm2, sarea=None,
                theta=None, mech=None, theta_deg=90.0,
                mechanism=MECH_FREEFREE | MECH_NEUTRALS,
                s_max=30, gaunt="dulk", carry=None):
    """Fold (Nz, n_pix) voxel arrays, voxel 0 first, into `carry` (four
    (n_pix, Nf) tensors; None: zeros) at `freqs` (Nf,): ds (cm), te (K), ne
    (cm^-3), b (G) float32, valid bool, and optionally sarea (cm^2, > 0
    overrides the pixel area), theta (radians, overrides theta_deg and
    swaps the slots where cos theta < 0) and mech (int32 mechanism bits,
    with `mechanism` their union), as make_voxel_update takes them; all
    contiguous on one device. Returns the carry. CPU tensors run
    fold_voxels_plain; CUDA tensors launch the kernel."""
    device = ds.device
    if ds.dim() != 2:
        raise ValueError(f"ds must be (Nz, n_pix), got {tuple(ds.shape)}")
    n = ds.shape[1]
    named = [("ds", ds, torch.float32), ("te", te, torch.float32),
             ("ne", ne, torch.float32), ("b", b, torch.float32),
             ("valid", valid, torch.bool)]
    for name, t, dtype in (("sarea", sarea, torch.float32),
                           ("theta", theta, torch.float32),
                           ("mech", mech, torch.int32)):
        if t is not None:
            named.append((name, t, dtype))
    for name, t, _ in named:
        if t.shape != ds.shape:
            raise ValueError(f"{name} must be (Nz, n_pix) {tuple(ds.shape)},"
                             f" got {tuple(t.shape)}")
    nf = _check_common(device, named, carry, n, freqs, gaunt)
    if device.type == "cpu":
        return fold_voxels_plain(ds, te, ne, b, valid, freqs, pixel_area_cm2,
                                 sarea, theta, mech, theta_deg, mechanism,
                                 s_max, gaunt, carry)
    _kernel_device(device, n, nf)
    if n == 0:
        return (tuple(carry) if carry is not None
                else transfer_carry_init(0, nf, device))
    out = torch.empty((4, n, nf), dtype=torch.float32, device=device)
    params = fold_params(n, nf, ds.shape[0], pixel_area_cm2, theta_deg,
                         mechanism, s_max, gaunt, theta is not None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    # a null carry is a zero one
    _launch("voxels", device, *(ptr(t) for t in (
        ds, te, ne, b, valid, sarea, theta, mech, freqs)),
        _tables_ptr(device, mechanism, s_max),
        *(ptr(c) for c in (carry or (None,) * 4)), out.data_ptr(),
        ctypes.byref(params))
    return tuple(out.unbind(0))


def fold_voxels_plain(ds, te, ne, b, valid, freqs, pixel_area_cm2,
                      sarea=None, theta=None, mech=None, theta_deg=90.0,
                      mechanism=MECH_FREEFREE | MECH_NEUTRALS,
                      s_max=30, gaunt="dulk", carry=None):
    """fold_voxels in plain torch, voxel by voxel, on any device, with
    make_voxel_update."""
    update = make_voxel_update(freqs, pixel_area_cm2, theta_deg, mechanism,
                               s_max, gaunt)
    if carry is None:
        carry = transfer_carry_init(ds.shape[1], freqs.shape[0], ds.device)
    if sarea is None:
        sarea = torch.zeros_like(ds)
    for k in range(ds.shape[0]):
        carry = update(carry, ds[k], te[k], ne[k], b[k], valid[k], sarea[k],
                       None if theta is None else theta[k],
                       None if mech is None else mech[k])
    return tuple(carry)
