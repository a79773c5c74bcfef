"""The plain reference of the transfer and the finish: records folded into
the two-mode fluxes, then T_b and V/I.

Frozen copies, in plain torch, of the port's plain record fold
(raytracinggrff_tpu_torch/ops/transfer_fold.fold_records_plain with
ops/los_scans.record_step), its voxel update (grff/transfer.
make_voxel_update) and free-free physics (grff/physics.py), for the
mechanisms the configurations use: free-free with the neutral-hydrogen
term (mechanism 5) at a fixed theta and the Dulk Coulomb logarithm. The
finish is pipeline.run_ray_tracing_emission's: T_b by tb_from_sfu, V/I,
non-finite T_b set to 0, both as float64 numpy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import (AU_CM, C_CGS, CHI_H_OVER_K, FB_COEF, FPE_COEF,
                        KAPPA_FF_COEF, KB_CGS, M_E_G, R_SUN_CM, SAHA_COEF,
                        SFU2CGS, SIGMA_EH_CM2)

MECH_FREEFREE = 1
MECH_GYRORESONANCE = 2
MECH_NEUTRALS = 4
O_MODE = 1.0
X_MODE = -1.0


def coulomb_log(te, nu):
    """Piecewise Coulomb logarithm (Dulk 1985 Section 2)."""
    ln_t = torch.log(te)
    ln_nu = torch.log(nu)
    low = 18.2 + 1.5 * ln_t - ln_nu
    high = 24.5 + ln_t - ln_nu
    return torch.clamp(torch.where(te < 2e5, low, high), min=0.0)


def refractive_index_sq(X, Y, theta_rad, sigma):
    """Appleton-Hartree n^2 for mode sigma; <= 0 means evanescent."""
    st = torch.sin(theta_rad)
    ct = torch.cos(theta_rad)
    yt2 = (Y * st) ** 2
    yl2 = (Y * ct) ** 2
    one_m_x = 1.0 - X
    root = torch.sqrt(yt2 * yt2 / 4.0 + one_m_x * one_m_x * yl2)
    denom = one_m_x - yt2 / 2.0 + sigma * root
    safe = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    return 1.0 - X * one_m_x / safe


def saha_neutral_hydrogen(ne, te):
    """Neutral-hydrogen density from the Saha equation, n_p ~= n_e."""
    te = torch.clamp(te, min=500.0)
    rhs = SAHA_COEF * te ** 1.5 * torch.exp(-CHI_H_OVER_K / te)
    return ne * ne / torch.clamp(rhs, min=1e-30)


def _mode_terms(ne, b, nu, theta_rad, sigma):
    nu_p_sq = (FPE_COEF ** 2) * ne
    nu_b = FB_COEF * b
    n2 = refractive_index_sq(nu_p_sq / (nu * nu), nu_b / nu, theta_rad, sigma)
    n_sigma = torch.sqrt(torch.clamp(n2, min=1e-12))
    eff_nu = nu + sigma * nu_b * torch.abs(torch.cos(theta_rad))
    eff_nu_sq = torch.clamp(eff_nu * eff_nu, min=1e-30)
    return nu_p_sq, n2, n_sigma, eff_nu_sq


def _neutral_term(ne, te, nu_p_sq, n_sigma, eff_nu_sq):
    n_h = saha_neutral_hydrogen(ne, te)
    v_mean = torch.sqrt(8.0 * KB_CGS * te / (math.pi * M_E_G))
    nu_en = n_h * SIGMA_EH_CM2 * v_mean
    return nu_p_sq / eff_nu_sq * nu_en / (C_CGS * n_sigma)


def freefree_kappa(ne, te, b, nu, theta_rad, sigma, include_neutrals):
    """Free-free opacity of one mode with the Dulk Coulomb logarithm:
    (kappa, n_sigma^2)."""
    nu_p_sq, n2, n_sigma, eff_nu_sq = _mode_terms(ne, b, nu, theta_rad,
                                                  sigma)
    lnlam = coulomb_log(te, nu)
    t32 = te * torch.sqrt(te)
    kappa = (KAPPA_FF_COEF * ne * (1.0 * ne) * lnlam
             / (n_sigma * eff_nu_sq * t32))
    if include_neutrals:
        kappa = kappa + _neutral_term(ne, te, nu_p_sq, n_sigma, eff_nu_sq)
    return kappa, n2


def make_voxel_update(freqs, pixel_area_cm2, theta_deg, mechanism, dtype):
    """The voxel update of free-free (bit 1) with neutrals (bit 4) at a
    fixed theta: (carry, ds, te, ne, b, mask, sarea) -> carry."""
    if mechanism & MECH_GYRORESONANCE or not mechanism & MECH_FREEFREE:
        raise ValueError(f"the reference folds mechanisms 1 and 5, got "
                         f"{mechanism}")
    device = freqs.device
    theta0 = torch.tensor(np.deg2rad(theta_deg), dtype=dtype, device=device)
    include_neutrals = bool(mechanism & MECH_NEUTRALS)
    area_default = torch.tensor(pixel_area_cm2, dtype=dtype, device=device)
    src_coef = (torch.tensor(KB_CGS / (C_CGS * C_CGS) / SFU2CGS, dtype=dtype,
                             device=device) * (freqs * freqs))
    inv_au = torch.tensor(1.0 / AU_CM, dtype=dtype, device=device)
    inv_au_sq = inv_au * inv_au

    def update(carry, ds_k, te_k, ne_k, b_k, mask_k, sarea_k):
        f_o, f_x, t_o, t_x = carry
        theta = theta0
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

        def coeffs(sigma):
            kappa, n2 = freefree_kappa(ne_s, te_s, b_s, nu, theta, sigma,
                                       include_neutrals)
            tau = torch.where(m, kappa * ds_s, 0.0)
            tau = torch.where(torch.isfinite(tau), tau, 0.0)
            evan = m & (n2 <= 0.0)
            return tau, evan

        tau_os, evan_os = coeffs(O_MODE)
        tau_xs, evan_xs = coeffs(X_MODE)
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


def record_step(pos, s, prev, scale):
    """One step of the ds scan: (valid, ds in cm, new last valid
    positions)."""
    valid = (torch.all(torch.isfinite(pos), dim=-1)
             & torch.isfinite(s) & (s > 0.0))
    p_safe = torch.where(valid[:, None], pos, prev)
    d = torch.sqrt(torch.sum((p_safe - prev) ** 2, dim=-1)) * scale
    return valid, torch.where(valid, d, 0.0), p_safe


def fold_records(recs, start, freqs, pixel_area_cm2, theta_deg, mechanism,
                 s_on, dtype):
    """Fold every record of `recs` (n_records, 8, n) into the carry, from
    the ray starts `start` (n, 3): (flux_o, flux_x), each (n, Nf)."""
    n, nf = recs.shape[2], freqs.shape[0]
    update = make_voxel_update(freqs, pixel_area_cm2, theta_deg, mechanism,
                               dtype)
    z = torch.zeros((n, nf), dtype=dtype, device=recs.device)
    carry = (z, z, z, z)
    prev = torch.as_tensor(start, device=recs.device).to(dtype).contiguous()
    area32 = np.float32(pixel_area_cm2)
    scale = np.float32(R_SUN_CM)
    for rec in recs:
        s = rec[3]
        valid, dsv, prev = record_step(rec[0:3].T, s, prev, scale)
        sarea = s * area32 if s_on else torch.zeros_like(s)
        carry = update(carry, dsv, rec[5], rec[4], rec[6], valid, sarea)
    return carry[0], carry[1]


def tb_from_sfu(flux_sfu, freq_hz, pixel_area_cm2):
    """SFU flux -> Rayleigh-Jeans brightness temperature, K."""
    conv = (SFU2CGS * C_CGS * C_CGS
            / (2.0 * KB_CGS * freq_hz * freq_hz)
            / pixel_area_cm2) * (AU_CM * AU_CM)
    return flux_sfu * conv


def finish(flux_o, flux_x, frequencies_hz, pixel_area_cm2, dtype):
    """(T_b, V/I) of the fluxes, each (n, Nf) float64 numpy."""
    freqs = torch.as_tensor(frequencies_hz, device=flux_o.device).to(dtype)
    intensity = flux_o + flux_x
    pol_vi = (flux_o - flux_x) / (intensity + 1e-30)
    tb = tb_from_sfu(intensity, freqs, pixel_area_cm2)
    tb = torch.nan_to_num(tb, nan=0.0, posinf=0.0, neginf=0.0)
    return (tb.cpu().float().numpy().astype(np.float64),
            pol_vi.cpu().float().numpy().astype(np.float64))


def log_spaced_freqs(freq0_hz, nfreq, freq_log_step):
    """f_i = f0 * 10^(i * dlog), float64 numpy."""
    return freq0_hz * (10.0 ** (freq_log_step * np.arange(nfreq)))
