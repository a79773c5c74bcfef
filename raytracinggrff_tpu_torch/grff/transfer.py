"""Two-mode radiative transfer along rays and lines of sight, in torch.

The transfer of raytracinggrff_tpu/grff/transfer.py: for each mode sigma
the refraction invariant J = I/n_sigma^2 obeys, voxel by voxel,

    J <- J * exp(-tau) + (k_B T nu^2 / c^2) * (1 - exp(-tau)),

invalid voxels (mask False, non-finite fields, or ds == 0) contribute
nothing, evanescent voxels (n_sigma^2 <= 0) block the mode, and a per-voxel
source area s_area > 0 replaces the pixel area (Parms[14]). flux_o fills the
reference's RL[5] slot and flux_x RL[6].

Voxel arrays are step-major (Nz, n_pix); voxel 0 is the far end of the
integration and the emergent intensity is taken after the last voxel.
`make_voxel_update` is the one voxel update; `grff_transfer` folds the
voxels of a batch through it (ops/transfer_fold.fold_voxels, a CUDA kernel
on the card), and `get_mw`/`get_mw_slice` are the GET_MW entry
points (script/synthetic_FF_map_single_thread.py:27-35,
script/resample_with_ray_tracing.py:400-466), with the DEM mode (its
recurrence over voxels ops/los_scans.dem_scan, a CUDA kernel on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import AU_CM, C_CGS, FB_COEF, FPE_COEF, KB_CGS, SFU2CGS
from ..ops.los_scans import dem_scan
from .physics import (KAPPA_FF_COEF, KAPPA_FF_EXACT_COEF, O_MODE, X_MODE,
                      dem_freefree_moments, freefree_kappa,
                      gyroresonance_kappa, neutral_hydrogen_kappa,
                      refractive_index_sq)

MECH_FREEFREE = 1
MECH_GYRORESONANCE = 2
MECH_NEUTRALS = 4


class GrffResult(NamedTuple):
    freqs_ghz: torch.Tensor   # (Nf,)
    flux_o: torch.Tensor      # (n_pix, Nf) SFU, RL[5] slot
    flux_x: torch.Tensor      # (n_pix, Nf) SFU, RL[6] slot
    tau_o: torch.Tensor       # (n_pix, Nf) total optical depth
    tau_x: torch.Tensor


def log_spaced_freqs(freq0_hz, nfreq, freq_log_step):
    """f_i = f0 * 10^(i*dlog) as float64 numpy (Rparms contract)."""
    return freq0_hz * (10.0 ** (freq_log_step * np.arange(nfreq)))


def make_voxel_update(freqs, pixel_area_cm2, theta_deg=90.0,
                      mechanism=MECH_FREEFREE | MECH_NEUTRALS, s_max=30,
                      gaunt="dulk"):
    """Build the per-voxel update; `freqs` is a float32 (Nf,) tensor on
    the device the update runs on.

    Returned fn: (carry, ds_k, te_k, ne_k, b_k, mask_k, sarea_k[, theta_k]
    [, mech_k]) -> carry, with carry = (flux_o, flux_x, tau_o, tau_x), each
    (n_pix, Nf), and per-pixel (n_pix,) voxel values. theta_k (radians)
    overrides theta_deg per voxel; mech_k (int) overrides the mechanism
    flags per voxel, with `mechanism` then the bitwise union of all
    per-voxel values. The neutral term (bit 4) counts only where free-free
    (bit 1) is on; gyroresonance (bit 2) sums harmonics 2..s_max. Where
    cos(theta) < 0 (B against k) the two output slots swap, so
    flux_o - flux_x is a signed Stokes-V proxy."""
    device = freqs.device
    f32 = torch.float32
    theta0 = torch.tensor(np.deg2rad(theta_deg), dtype=f32, device=device)
    include_ff = bool(mechanism & MECH_FREEFREE)
    include_neutrals = bool(mechanism & MECH_NEUTRALS)
    include_gr = bool(mechanism & MECH_GYRORESONANCE)
    area_default = torch.tensor(pixel_area_cm2, dtype=f32, device=device)
    src_coef = (torch.tensor(KB_CGS / (C_CGS * C_CGS) / SFU2CGS, dtype=f32,
                             device=device) * (freqs * freqs))
    inv_au = torch.tensor(1.0 / AU_CM, dtype=f32, device=device)
    inv_au_sq = inv_au * inv_au

    def update(carry, ds_k, te_k, ne_k, b_k, mask_k, sarea_k, theta_k=None,
               mech_k=None):
        f_o, f_x, t_o, t_x = carry
        theta = theta0 if theta_k is None else theta_k[:, None]
        mask = (mask_k & torch.isfinite(ne_k) & torch.isfinite(te_k)
                & torch.isfinite(b_k) & torch.isfinite(ds_k) & (ds_k > 0))
        ne_s = torch.where(mask, ne_k, 1.0)[:, None]
        te_s = torch.where(mask, te_k, 1e6)[:, None]
        b_s = torch.where(mask, b_k, 0.0)[:, None]
        ds_s = torch.where(mask, ds_k, 0.0)[:, None]
        m = mask[:, None]
        area = (torch.where(sarea_k > 0, sarea_k, area_default)
                * inv_au_sq)[:, None]
        nu = freqs[None, :]

        def gyro(sigma):
            return gyroresonance_kappa(ne_s, te_s, b_s, nu, theta, sigma,
                                       s_max=s_max)

        def coeffs(sigma):
            if mech_k is None:
                kappa, n2 = freefree_kappa(
                    ne_s, te_s, b_s, nu, theta, sigma,
                    include_neutrals=include_neutrals, gaunt=gaunt)
                if not include_ff:
                    kappa = torch.zeros_like(kappa)
                if include_gr:
                    kappa = kappa + gyro(sigma)
            else:
                kappa_ff, n2 = freefree_kappa(
                    ne_s, te_s, b_s, nu, theta, sigma,
                    include_neutrals=False, gaunt=gaunt)
                ff_on = ((mech_k & MECH_FREEFREE) != 0)[:, None]
                kappa = torch.where(ff_on & include_ff, kappa_ff, 0.0)
                if include_ff and include_neutrals:
                    n_on = ff_on & ((mech_k & MECH_NEUTRALS) != 0)[:, None]
                    kappa = kappa + torch.where(
                        n_on, neutral_hydrogen_kappa(
                            ne_s, te_s, b_s, nu, theta, sigma), 0.0)
                if include_gr:
                    gr_on = ((mech_k & MECH_GYRORESONANCE) != 0)[:, None]
                    kappa = kappa + torch.where(gr_on, gyro(sigma), 0.0)
            tau = torch.where(m, kappa * ds_s, 0.0)
            tau = torch.where(torch.isfinite(tau), tau, 0.0)
            evan = m & (n2 <= 0.0)
            return tau, evan

        tau_p, evan_p = coeffs(O_MODE)
        tau_m, evan_m = coeffs(X_MODE)
        if theta_k is None:
            tau_os, evan_os, tau_xs, evan_xs = tau_p, evan_p, tau_m, evan_m
        else:
            # B against k flips the handedness; the dead zone absorbs the
            # f32 arccos/cos round trip at exactly perpendicular B
            swap = torch.cos(theta) < -1e-6
            tau_os = torch.where(swap, tau_m, tau_p)
            evan_os = torch.where(swap, evan_m, evan_p)
            tau_xs = torch.where(swap, tau_p, tau_m)
            evan_xs = torch.where(swap, evan_p, evan_m)

        src = te_s * src_coef[None, :] * area

        def apply(f, t_sum, tau, evan):
            f_new = (f * torch.exp(-tau)
                     + torch.where(m, src * -torch.expm1(-tau), 0.0))
            f_new = torch.where(evan, 0.0, f_new)
            t_new = torch.where(evan, torch.inf, t_sum + tau)
            return f_new, t_new

        f_o, t_o = apply(f_o, t_o, tau_os, evan_os)
        f_x, t_x = apply(f_x, t_x, tau_xs, evan_xs)
        return (f_o, f_x, t_o, t_x)

    return update


def transfer_carry_init(n_pix, nf, device):
    z = torch.zeros((n_pix, nf), dtype=torch.float32, device=device)
    return (z, z, z, z)


def _per_voxel(values, shape, dtype, device):
    """A scalar-per-voxel (Nz,) or full (Nz, n_pix) array as a (Nz, n_pix)
    tensor."""
    t = torch.as_tensor(values, dtype=dtype, device=device)
    if t.dim() == 1:
        t = t[:, None]
    return t.expand(shape)


def grff_transfer(ds, te, ne, b, valid, freqs_hz, pixel_area_cm2,
                  s_area_cm2=None, theta_deg=90.0,
                  mechanism: int = MECH_FREEFREE | MECH_NEUTRALS,
                  s_max: int = 30, gaunt: str = "dulk",
                  device="cuda") -> GrffResult:
    """Batch transfer of (Nz, n_pix) voxel arrays (numpy or tensors; ds
    in cm, te K, ne cm^-3, b G, valid bool) at freqs_hz (Nf,) on `device`.
    theta_deg is a scalar or per-voxel (Nz,) / (Nz, n_pix) degrees
    (Parms[4]); mechanism an int or a per-voxel host array whose bitwise
    union decides which terms are computed (Parms[6]); s_max caps the gyro
    harmonics (Parms[7]); s_area_cm2 (Nz, n_pix) > 0 overrides the pixel
    area (Parms[14]). One ops/transfer_fold.fold_voxels call folds every
    voxel (the JAX package's _grff_transfer_jit scan)."""
    # ops.transfer_fold builds on this module's voxel update
    from ..ops.transfer_fold import fold_voxels
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(a, dtype=dtype, device=device).contiguous()

    ds, te, ne, b = t(ds), t(te), t(ne), t(b)
    valid = t(valid, torch.bool)
    freqs = t(np.asarray(freqs_hz, np.float64))
    shape = ds.shape
    sarea = (None if s_area_cm2 is None
             else t(s_area_cm2).expand(shape).contiguous())
    theta = None
    if np.ndim(theta_deg) > 0:
        theta = torch.deg2rad(_per_voxel(theta_deg, shape, f32,
                                         device)).contiguous()
        theta_deg = -1.0        # unused with per-voxel theta
    mech = None
    if np.ndim(mechanism) > 0:
        m = np.asarray(mechanism, np.int32)
        mech = _per_voxel(m, shape, torch.int32, device).contiguous()
        mechanism = int(np.bitwise_or.reduce(m.reshape(-1))) if m.size else 0
    f_o, f_x, t_o, t_x = fold_voxels(
        ds, te, ne, b, valid, freqs, pixel_area_cm2, sarea, theta, mech,
        float(theta_deg), int(mechanism), int(s_max), str(gaunt))
    return GrffResult(freqs_ghz=freqs / 1e9, flux_o=f_o, flux_x=f_x,
                      tau_o=t_o, tau_x=t_x)


def tb_from_sfu(flux_sfu, freq_hz, pixel_area_cm2):
    """SFU flux -> Rayleigh-Jeans brightness temperature, K:
    T_b = F * 1e-19 * c^2 / (2 k_B nu^2) / pixel_area * AU^2
    (script/resample_with_ray_tracing.py:95-97)."""
    conv = (SFU2CGS * C_CGS * C_CGS
            / (2.0 * KB_CGS * freq_hz * freq_hz)
            / pixel_area_cm2) * (AU_CM * AU_CM)
    return flux_sfu * conv


def _is_dummy(arr):
    """The reference's dummy-scalar convention: None, or a <=1-element
    zero array (script/synthetic_FF_map_single_thread.py:203-208)."""
    if arr is None:
        return True
    arr = np.asarray(arr, np.float64)
    return arr.size <= 1 and (arr.size == 0
                              or float(arr.reshape(-1)[0]) == 0.0)


def _classify_dem_inputs(lparms, nz, t, dem, ddm):
    """Validate the DEM/DDM part of the GET_MW ABI. Returns (t_grid,
    dem_arr), float64 of shapes (NT,) and (NT, Nz), when DEM mode is on
    (Lparms[2] = NT > 0 with a real T/DEM pair), else None. DDM mode
    (Lparms[4] != 0 or a non-dummy DDM array) raises NotImplementedError;
    half-dummy input is an error, not a silent fallback."""
    lparms = np.asarray(lparms)
    nt = int(lparms[2]) if lparms.size > 2 else 0
    if (lparms.size > 4 and lparms[4] != 0) or not _is_dummy(ddm):
        raise NotImplementedError(
            "DDM transfer mode (Lparms[4] != 0 / non-dummy DDM array) is "
            "not implemented; DEM mode (Lparms[2] = NT with a T/DEM pair) "
            "is supported")
    if nt <= 0:
        if not (_is_dummy(t) and _is_dummy(dem)):
            raise ValueError(
                "non-dummy T/DEM arrays passed with Lparms[2] = 0; set "
                "Lparms[2] = NT to enable the DEM transfer mode")
        return None
    if nt == 1:
        raise ValueError("DEM mode needs NT >= 2 temperature nodes")
    if _is_dummy(t) or _is_dummy(dem):
        raise ValueError(
            f"DEM mode requested (Lparms[2] = {nt}) but T/DEM are the "
            "dummy scalars; pass a real (NT,) T grid and (NT, Nz) DEM")
    t_grid = np.asarray(t, np.float64).reshape(-1)
    if t_grid.size != nt:
        raise ValueError(f"T grid has {t_grid.size} nodes, Lparms[2]={nt}")
    if np.any(np.diff(t_grid) <= 0) or np.any(t_grid <= 0):
        raise ValueError("T grid must be positive and strictly ascending")
    dem_arr = np.asarray(dem, np.float64)
    if dem_arr.size != nt * nz:
        raise ValueError(
            f"DEM must have NT*Nz = {nt * nz} entries (column-major "
            f"(NT, Nz) like Parms), got {dem_arr.size}")
    return t_grid, dem_arr.reshape(nt, nz, order="F")   # column-major ABI


def _grff_transfer_dem(ds, te, ne, b, theta_rad, sarea, mech, t_grid, dem,
                       freqs, pixel_area_cm2, mechanism, s_max, gaunt,
                       device):
    """Single-LOS two-mode transfer with DEM(T) free-free
    (physics.dem_freefree_moments). ds/te/ne/b/theta_rad/sarea/mech are
    (Nz,), t_grid (NT,), dem (NT, Nz), freqs (Nf,); `mechanism` is the bit
    union of `mech`. The dispersion and evanescence use the thermal n_e of
    Parms[2]; the neutral and gyro terms, where flagged, use the Parms
    temperature and add kappa*ds; the voxel's source temperature is the
    opacity-weighted mix of T_eff(nu) and T_e. Returns (flux_o, flux_x,
    tau_o, tau_x), each (Nf,)."""
    f32 = torch.float32

    def t(a, dtype=f32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    ds, te, ne, b, sarea = t(ds), t(te), t(ne), t(b), t(sarea)
    theta = t(theta_rad)[:, None]
    freqs = t(freqs)
    nu = freqs[None, :]
    include_ff = bool(mechanism & MECH_FREEFREE)
    include_neutrals = bool(mechanism & MECH_NEUTRALS)
    include_gr = bool(mechanism & MECH_GYRORESONANCE)

    valid = (torch.isfinite(ds) & (ds > 0) & torch.isfinite(ne)
             & torch.isfinite(te) & torch.isfinite(b))
    ne_s = torch.where(valid, ne, 1.0)[:, None]
    te_s = torch.where(valid, te, 1e6)[:, None]
    b_s = torch.where(valid, b, 0.0)[:, None]
    ds_s = torch.where(valid, ds, 0.0)[:, None]
    m = valid[:, None]

    m_k, t_eff = dem_freefree_moments(t(t_grid), t(dem), freqs, gaunt=gaunt)
    coef = KAPPA_FF_EXACT_COEF if gaunt == "exact" else KAPPA_FF_COEF
    X = (FPE_COEF ** 2) * ne_s / (nu * nu)
    nu_b = FB_COEF * b_s
    Y = nu_b / nu
    inv_au = torch.tensor(1.0 / AU_CM, dtype=f32, device=device)
    area = (torch.where(sarea > 0, sarea,
                        torch.tensor(pixel_area_cm2, dtype=f32,
                                     device=device))[:, None]
            * inv_au * inv_au)
    src_coef = (torch.tensor(KB_CGS / (C_CGS * C_CGS) / SFU2CGS, dtype=f32,
                             device=device) * (freqs * freqs))[None, :]
    mech = t(mech, torch.int32)
    ff_on = ((mech & MECH_FREEFREE) != 0)[:, None]
    n_on = ff_on & ((mech & MECH_NEUTRALS) != 0)[:, None]
    gr_on = ((mech & MECH_GYRORESONANCE) != 0)[:, None]

    def mode(sigma):
        n2 = refractive_index_sq(X, Y, theta, sigma)
        n_sig = torch.sqrt(torch.clamp(n2, min=1e-12))
        eff = nu + sigma * nu_b * torch.abs(torch.cos(theta))
        eff2 = torch.clamp(eff * eff, min=1e-30)
        if include_ff:
            tau_ff = torch.where(ff_on, coef * m_k / (n_sig * eff2), 0.0)
        else:
            tau_ff = torch.zeros_like(m_k)
        tau_th = torch.zeros_like(m_k)
        if include_ff and include_neutrals:
            tau_th = tau_th + torch.where(n_on, neutral_hydrogen_kappa(
                ne_s, te_s, b_s, nu, theta, sigma) * ds_s, 0.0)
        if include_gr:
            tau_th = tau_th + torch.where(gr_on, gyroresonance_kappa(
                ne_s, te_s, b_s, nu, theta, sigma, s_max=s_max) * ds_s, 0.0)
        tau = torch.where(m, tau_ff + tau_th, 0.0)
        tau = torch.where(torch.isfinite(tau), tau, 0.0)
        src_t = ((tau_ff * t_eff + tau_th * te_s)
                 / torch.clamp(tau_ff + tau_th, min=1e-30))
        src = src_t * src_coef * area
        evan = m & (n2 <= 0.0)
        return tau, src, evan

    # the recurrence over voxels: a CUDA kernel on the card
    tau, src, evan = (torch.stack(a) for a in zip(mode(O_MODE),
                                                  mode(X_MODE)))
    (f_o, t_o), (f_x, t_x) = dem_scan(tau, src, evan, valid)
    return f_o, f_x, t_o, t_x


def get_mw(lparms, rparms, parms, t=None, dem=None, ddm=None,
           device="cuda"):
    """Single-LOS GET_MW entry (script/synthetic_FF_map_single_thread.py:
    27-35, 189-208), computed on `device`.

    lparms: [Nz, Nf, NT, key_DEM, key_DDM] int; rparms: [area_cm2, f0_hz,
    dlogf]; parms: (15, Nz) with rows 0: ds cm, 1: T K, 2: n_e cm^-3,
    3: |B| G, 4: theta deg, 6: mechanism flags, 7: max harmonic,
    14: per-voxel source area cm^2. Parms[4] and Parms[6] may vary per
    voxel. DEM mode (Lparms[2] = NT >= 2 with a real T/DEM pair): t is the
    ascending (NT,) T grid in K and dem the column-major (NT, Nz) DEM
    [cm^-5 K^-1]; the dummy scalars select the uniform-T path, and DDM mode
    raises NotImplementedError. Returns RL (7, Nf) float64: RL[0] f GHz,
    RL[1]/RL[2] the total optical depths, RL[5] O-mode SFU, RL[6] X-mode.
    """
    parms = np.asarray(parms, np.float64)
    nz = int(lparms[0])
    nf = int(lparms[1])
    dem_inputs = _classify_dem_inputs(lparms, nz, t, dem, ddm)
    freqs = log_spaced_freqs(float(rparms[1]), nf, float(rparms[2]))
    s_max = int(parms[7, 0]) if nz and parms[7, 0] > 0 else 30
    rl = np.zeros((7, nf))

    def put(freqs_ghz, t_o, t_x, f_o, f_x):
        for row, v in ((0, freqs_ghz), (1, t_o), (2, t_x), (5, f_o),
                       (6, f_x)):
            rl[row] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
        return rl

    if dem_inputs is not None:
        t_grid, dem_arr = dem_inputs
        mech_col = parms[6, :nz].astype(np.int32)
        mech_union = int(np.bitwise_or.reduce(mech_col)) if nz else 1
        f_o, f_x, t_o, t_x = _grff_transfer_dem(
            parms[0, :nz], parms[1, :nz], parms[2, :nz], parms[3, :nz],
            np.deg2rad(parms[4, :nz]), parms[14, :nz], mech_col, t_grid,
            dem_arr, freqs, float(rparms[0]), mech_union, s_max, "dulk",
            device)
        return put(freqs / 1e9, t_o, t_x, f_o, f_x)
    # constant flags and theta keep the scalar path
    mech = parms[6, :nz].astype(np.int32) if nz else np.array([5], np.int32)
    mechanism = int(mech[0]) if np.ptp(mech) == 0 else mech
    theta = parms[4, :nz] if nz else 90.0
    if nz and np.ptp(theta) == 0.0:
        theta = float(theta[0])
    res = grff_transfer(
        ds=parms[0, :nz, None], te=parms[1, :nz, None],
        ne=parms[2, :nz, None], b=parms[3, :nz, None],
        valid=np.ones((nz, 1), bool), freqs_hz=freqs,
        pixel_area_cm2=float(rparms[0]), s_area_cm2=parms[14, :nz, None],
        theta_deg=theta, mechanism=mechanism, s_max=s_max, device=device)
    return put(res.freqs_ghz, res.tau_o[0], res.tau_x[0], res.flux_o[0],
               res.flux_x[0])


def get_mw_slice(ds, te, ne, b, valid, freq0_hz, nfreq, freq_log_step,
                 pixel_area_cm2, s_area_cm2=None, theta_deg=90.0,
                 mechanism=MECH_FREEFREE | MECH_NEUTRALS, gaunt="dulk",
                 device="cuda"):
    """Batched all-pixels transfer (the fastGRFF get_mw_slice,
    script/resample_with_ray_tracing.py:400-466) on `device`, with the
    arrays kept there. theta_deg may be a scalar or per-voxel (Nz,) /
    (Nz, n_pix) (Parms[4]); mechanism an int or per-voxel host array."""
    freqs = log_spaced_freqs(float(freq0_hz), int(nfreq),
                             float(freq_log_step))
    if np.ndim(theta_deg) == 0:
        theta_deg = float(theta_deg)
    if np.ndim(mechanism) == 0:
        mechanism = int(mechanism)
    return grff_transfer(ds, te, ne, b, valid, freqs, pixel_area_cm2,
                         s_area_cm2=s_area_cm2, theta_deg=theta_deg,
                         mechanism=mechanism, gaunt=gaunt, device=device)
