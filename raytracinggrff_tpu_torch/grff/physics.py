"""Free-free / magnetoionic plasma emission physics (CGS) on torch tensors.

The formulas of raytracinggrff_tpu/grff/physics.py, which documents their
derivation: Appleton-Hartree refractive index per mode sigma (+1 O, -1 X),
free-free opacity with the Dulk 1985 Coulomb logarithm or the exact
classical/Born Gaunt factor, the Saha neutral-hydrogen term (mechanism
bit 4), thermal gyroresonance with the exact polarization coupling
(mechanism bit 2) and the free-free moments of a DEM(T). The functions
take tensors of any float dtype; the transfer runs them in float32.
"""

from __future__ import annotations

import math

import torch

from ..constants import (C_CGS, E_ESU, FB_COEF, FPE_COEF, H_ERG_S, KB_CGS,
                         M_E_G)

KAPPA_FF_COEF = 9.786e-3      # Dulk 1985, cm^-1 with nu in Hz, T in K
_GAMMA_EULER = 0.5772156649015329
SQRT3_OVER_PI = math.sqrt(3.0) / math.pi


def _exact_gaunt_constants():
    e, m, c, k, h = E_ESU, M_E_G, C_CGS, KB_CGS, H_ERG_S
    coef = (4.0 * e ** 6 / (3.0 * m * c * k)) * math.sqrt(
        2.0 * math.pi / (3.0 * k * m))
    g_cl = math.log((2.0 * k) ** 1.5
                    / (math.pi * e * e * math.sqrt(m) * math.exp(_GAMMA_EULER)))
    g_born = math.log(4.0 * k / (math.exp(_GAMMA_EULER) * h))
    return coef, g_cl, g_born


KAPPA_FF_EXACT_COEF, GAUNT_CL_CONST, GAUNT_BORN_CONST = \
    _exact_gaunt_constants()
SAHA_COEF = 2.4147e15         # n_e n_p / n_H = SAHA_COEF T^1.5 exp(-CHI/T)
CHI_H_OVER_K = 1.5789e5       # 13.6 eV / k_B, K
SIGMA_EH_CM2 = 3.5e-15        # low-energy elastic e-H cross-section, cm^2

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


def exact_gaunt(te, nu):
    """Frequency-averaged free-free Gaunt factor, max(classical, Born)."""
    ln_t = torch.log(te)
    ln_nu = torch.log(nu)
    g_cl = GAUNT_CL_CONST + 1.5 * ln_t - ln_nu
    g_born = GAUNT_BORN_CONST + ln_t - ln_nu
    return SQRT3_OVER_PI * torch.clamp(torch.maximum(g_cl, g_born), min=0.0)


def _mode_terms(ne, b, nu, theta_rad, sigma):
    """(nu_p^2, n^2, n_sigma, eff_nu^2) of one magnetoionic mode."""
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


def neutral_hydrogen_kappa(ne, te, b, nu, theta_rad, sigma):
    """Electron-neutral-hydrogen collisional opacity [cm^-1] alone
    (mechanism bit 4)."""
    nu_p_sq, _, n_sigma, eff_nu_sq = _mode_terms(ne, b, nu, theta_rad, sigma)
    return _neutral_term(ne, te, nu_p_sq, n_sigma, eff_nu_sq)


def gyro_polarization_coupling(X, Y, theta_rad, sigma):
    """Exact magnetoionic polarization coupling F_sigma(theta) of thermal
    gyroresonance: the projection of the mode's cold-plasma polarization
    onto the electron-sense rotation about B, |e_x - i e_y|^2 / ||e||^2.
    With the Stix S, D, P, A = n^2_sigma - S and d = P - n^2 sin^2:

        F = (A + D)^2 d^2 / (A^2 d^2 + D^2 d^2 + A^2 n^4 cos^2 sin^2),

    which tends to the quasi-longitudinal (1 - sigma|cos|)^2 / 2 and keeps
    the X/O asymmetry near 90 deg (derivation and limits in
    raytracinggrff_tpu/grff/physics.py)."""
    n2 = refractive_index_sq(X, Y, theta_rad, sigma)
    one_m_y2 = 1.0 - Y * Y
    safe = torch.where(torch.abs(one_m_y2) > 1e-12, one_m_y2,
                       torch.where(one_m_y2 >= 0, 1e-12, -1e-12))
    s_stix = 1.0 - X / safe
    d_stix = -X * Y / safe
    p_stix = 1.0 - X
    st = torch.sin(theta_rad)
    ct = torch.cos(theta_rad)
    a = n2 - s_stix
    d_l = p_stix - n2 * st * st
    num = (a + d_stix) ** 2 * d_l * d_l
    den = ((a * a + d_stix * d_stix) * d_l * d_l
           + a * a * (n2 * n2) * (ct * st) ** 2)
    return num / torch.clamp(den, min=1e-38)


def gyroresonance_kappa(ne, te, b, nu, theta_rad, sigma, s_max=30):
    """Thermal gyroresonance opacity summed over harmonics s = 2..s_max
    [cm^-1] (mechanism bit 2; Parms[7] caps s):

        kappa_s = (pi^2/(2c)) (nu_p^2/nu) F_sigma (s^2/s!)
                  (s^2 beta^2 sin^2/2)^(s-1) s nu_B
                  Gauss(nu - s nu_B; s nu_B beta max(|cos|, 0.01)),

    beta^2 = kT/(m c^2). The harmonic terms are taken in log space with
    lgamma so s! stays in float32 range, and summed over a leading s axis
    in one pass, so the number of launches does not grow with s_max."""
    nu_p_sq = (FPE_COEF ** 2) * ne
    nu_b = torch.clamp(FB_COEF * b, min=1.0)
    beta2 = KB_CGS * te / (M_E_G * C_CGS * C_CGS)
    beta = torch.sqrt(beta2)
    st2 = torch.sin(theta_rad) ** 2
    act = torch.clamp(torch.abs(torch.cos(theta_rad)), min=0.01)
    f_sigma = gyro_polarization_coupling(nu_p_sq / (nu * nu), nu_b / nu,
                                         theta_rad, sigma)
    pref = (math.pi ** 2 / (2.0 * C_CGS)) * nu_p_sq / nu * f_sigma
    log_arg = torch.log(torch.clamp(beta2 * st2 / 2.0, min=1e-38))

    harmonics = range(2, int(s_max) + 1)
    lead = (-1,) + (1,) * max(pref.dim(), log_arg.dim())

    def per_s(values):
        return torch.tensor(values, dtype=pref.dtype,
                            device=pref.device).reshape(lead)

    s = per_s([float(k) for k in harmonics])
    log_s2 = per_s([2.0 * math.log(k) for k in harmonics])
    lgam = per_s([math.lgamma(k + 1) for k in harmonics])
    width = s * nu_b * beta * act
    log_term = log_s2 + (s - 1.0) * (log_arg + log_s2) - lgam
    gauss = (torch.exp(-((nu - s * nu_b) ** 2) / (2.0 * width * width))
             / (math.sqrt(2.0 * math.pi) * width))
    total = torch.sum((s * nu_b) * torch.exp(log_term) * gauss, dim=0)
    return pref * total


def trapezoid_weights(t_grid):
    """Trapezoid quadrature weights of an ascending 1-D grid tensor:
    w_0 = (T1-T0)/2, w_j = (T_{j+1}-T_{j-1})/2, w_last likewise."""
    dt = t_grid[1:] - t_grid[:-1]
    return torch.cat([dt[:1] / 2.0, (dt[1:] + dt[:-1]) / 2.0,
                      dt[-1:] / 2.0])


def dem_freefree_moments(t_grid, dem, nu, gaunt="dulk"):
    """Free-free kernel moments of a per-voxel DEM(T) [cm^-5 K^-1, the
    voxel's path length folded in]:

        M_k(nu) = int DEM g(T, nu) T^{-3/2} dT,
        T_eff(nu) = int DEM g T^{-1/2} dT / M_k(nu)   (trapezoid),

    so tau_sigma = coef M_k / (n_sigma eff_nu^2) and the source
    temperature is T_eff. t_grid (NT,), dem (NT, Nz), nu (Nf,) tensors;
    returns (m_k, t_eff), each (Nz, Nf). g is the Dulk lnLambda or, with
    gaunt='exact', the classical/Born Gaunt factor, as in freefree_kappa."""
    t = t_grid[:, None]
    nu2 = nu[None, :]
    g = exact_gaunt(t, nu2) if gaunt == "exact" else coulomb_log(t, nu2)
    w = trapezoid_weights(t_grid)[:, None]
    a_k = (dem * (w * t ** -1.5)).T
    a_j = (dem * (w * t ** -0.5)).T
    m_k = torch.matmul(a_k, g)
    m_j = torch.matmul(a_j, g)
    floor = 1e-300 if m_k.dtype == torch.float64 else 1e-38
    return m_k, m_j / torch.clamp(m_k, min=floor)


def freefree_kappa(ne, te, b, nu, theta_rad, sigma, include_neutrals=True,
                   zion_factor=1.0, gaunt="dulk"):
    """Free-free absorption coefficient [cm^-1] of one mode. Returns
    (kappa, n_sigma_sq); the caller tests n_sigma_sq <= 0 (evanescent).
    gaunt: 'dulk' (Dulk 1985 lnLambda, reference parity) or 'exact'."""
    nu_p_sq, n2, n_sigma, eff_nu_sq = _mode_terms(ne, b, nu, theta_rad,
                                                  sigma)
    if gaunt == "exact":
        coef = KAPPA_FF_EXACT_COEF
        lnlam = exact_gaunt(te, nu)
    else:
        coef = KAPPA_FF_COEF
        lnlam = coulomb_log(te, nu)
    t32 = te * torch.sqrt(te)
    kappa = (coef * ne * (zion_factor * ne) * lnlam
             / (n_sigma * eff_nu_sq * t32))
    if include_neutrals:
        kappa = kappa + _neutral_term(ne, te, nu_p_sq, n_sigma, eff_nu_sq)
    return kappa, n2
