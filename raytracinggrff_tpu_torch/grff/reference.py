"""Float64 reference of the GRFF transfer, on the CPU
(raytracinggrff_tpu/grff/reference.py).

The bar the port's maps are held to: T_b within 1% of this reference. It
evaluates the physics of grff/physics.py in float64 tensors on the CPU,
with an explicit loop over voxels, and never goes through
transfer.make_voxel_update (which pins float32 constants). It covers the
Parms contract of grff_transfer: mechanism bits 1/2/4 (free-free,
gyroresonance, neutrals), per-voxel theta with the handedness swap
(Parms[4]), per-voxel source areas (Parms[14]), the harmonic cap s_max
(Parms[7]) and both Gaunt options.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import AU_CM, C_CGS, KB_CGS, SFU2CGS
from .physics import O_MODE, X_MODE, freefree_kappa, gyroresonance_kappa


def grff_transfer_reference(ds, te, ne, b, valid, freqs_hz, pixel_area_cm2,
                            s_area_cm2=None, theta_deg=90.0,
                            include_neutrals=True, mechanism=None,
                            s_max=30, gaunt="dulk"):
    """The contract of transfer.grff_transfer, computed in float64 on the
    CPU from (Nz, n_pix) voxel arrays (numpy or tensors).

    mechanism: bit flags (1 free-free, 2 gyroresonance, 4 neutral-H); the
    legacy include_neutrals bool is honoured when mechanism is None.
    theta_deg: scalar, (Nz,) or (Nz, n_pix) degrees; per-voxel values swap
    the two output slots where cos(theta) < -1e-6 (handedness, as
    transfer.make_voxel_update). Returns a dict of float64 numpy arrays:
    flux_o, flux_x (n_pix, Nf) in SFU, tau_o, tau_x, and freqs_ghz."""
    f64 = torch.float64

    def t(a, dtype=f64):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    ds, te, ne, b = t(ds), t(te), t(ne), t(b)
    valid = t(valid, torch.bool)
    freqs = t(freqs_hz)
    nz, n_pix = ds.shape
    nf = freqs.shape[0]
    if mechanism is None:
        mechanism = 1 | (4 if include_neutrals else 0)
    include_ff = bool(mechanism & 1)
    include_gr = bool(mechanism & 2)
    include_n = bool(mechanism & 4)
    per_voxel_theta = np.ndim(theta_deg) > 0
    theta = torch.deg2rad(t(theta_deg))
    theta = theta.reshape((-1, 1) if theta.dim() == 1 else
                          (theta.shape or (1, 1))).expand(nz, n_pix)
    s_area = torch.zeros_like(ds) if s_area_cm2 is None else t(s_area_cm2)
    src_coef = KB_CGS / C_CGS ** 2 * freqs ** 2 / AU_CM ** 2 / SFU2CGS
    nu = freqs[None, :]

    zeros = torch.zeros((n_pix, nf), dtype=f64)
    flux = {O_MODE: zeros, X_MODE: zeros}
    tau_tot = {O_MODE: zeros, X_MODE: zeros}
    for k in range(nz):
        mask = (valid[k] & torch.isfinite(ne[k]) & torch.isfinite(te[k])
                & torch.isfinite(b[k]) & torch.isfinite(ds[k]) & (ds[k] > 0))
        if not bool(mask.any()):
            continue
        area = torch.where(s_area[k] > 0, s_area[k], pixel_area_cm2)
        theta_k = theta[k][:, None]
        ne_s = torch.where(mask, ne[k], 1.0)[:, None]
        te_s = torch.where(mask, te[k], 1e6)[:, None]
        b_s = torch.where(mask, b[k], 0.0)[:, None]
        m = mask[:, None]

        taus, evans = {}, {}
        for sigma in (O_MODE, X_MODE):
            kappa, n2 = freefree_kappa(ne_s, te_s, b_s, nu, theta_k, sigma,
                                       include_neutrals=include_n,
                                       gaunt=gaunt)
            if not include_ff:
                kappa = torch.zeros_like(kappa)
            if include_gr:
                kappa = kappa + gyroresonance_kappa(ne_s, te_s, b_s, nu,
                                                    theta_k, sigma,
                                                    s_max=s_max)
            tau = torch.where(m, kappa * ds[k][:, None], 0.0)
            taus[sigma] = torch.where(torch.isfinite(tau), tau, 0.0)
            evans[sigma] = m & (n2 <= 0.0)

        slot = {s: (taus[s], evans[s]) for s in (O_MODE, X_MODE)}
        if per_voxel_theta:
            # handedness: B against k swaps the two output slots
            swap = torch.cos(theta_k) < -1e-6
            slot = {
                O_MODE: (torch.where(swap, taus[X_MODE], taus[O_MODE]),
                         torch.where(swap, evans[X_MODE], evans[O_MODE])),
                X_MODE: (torch.where(swap, taus[O_MODE], taus[X_MODE]),
                         torch.where(swap, evans[O_MODE], evans[X_MODE]))}

        src = (torch.where(mask, te[k], 0.0)[:, None] * src_coef[None, :]
               * area[:, None])
        for sigma in (O_MODE, X_MODE):
            tau, evan = slot[sigma]
            att = torch.exp(-tau)
            f = flux[sigma] * att + src * (1.0 - att)
            flux[sigma] = torch.where(evan, 0.0, f)
            tau_tot[sigma] = torch.where(evan, torch.inf,
                                         tau_tot[sigma] + tau)

    return {"freqs_ghz": freqs.numpy() / 1e9,
            "flux_o": flux[O_MODE].numpy(), "flux_x": flux[X_MODE].numpy(),
            "tau_o": tau_tot[O_MODE].numpy(),
            "tau_x": tau_tot[X_MODE].numpy()}
