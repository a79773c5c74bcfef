"""The plain reference of the gyroresonance map: mechanism 7 (free-free,
neutrals and thermal gyroresonance over harmonics 2..S_MAX) with theta
taken per record from the angle between B and the wave vector
(theta_mode='los').

Frozen copies, in plain torch, of what the program adds for this map to
the free-free path that scene.py, trace.py and transfer.py copy:

  * the image-frame B-vector cubes of pipeline.prepare_cubes(keep_bvec=
    True) (pipeline._bvec_image_cubes), resampled as scene.py resamples
    the other cubes;
  * the 8-channel sample table [ne, te, b, Bx, By, Bz, 0, 0] of
    tracer_segments.prepare_trace_inputs and row 7 of a record, the
    signed cos(B, k) of ops/trace_segment.trace_segment_plain
    (tracer.cos_theta_signed), from the wave vector after the record's
    last step;
  * grff/physics.gyroresonance_kappa and gyro_polarization_coupling;
  * the voxel update of grff/transfer.make_voxel_update with a per-record
    theta (the slots swap where cos theta < -1e-6), and the record fold
    of ops/transfer_fold.fold_records_plain with theta_los: a record
    whose row 7 is not finite is not valid. That drops the record at
    which a ray leaving the cube froze (its wave vector is NaN, its S not
    yet 0), as the program does; the JAX package keeps it, and its NaN
    angle makes the voxel evanescent in both modes, which zeroes the
    pixel (a departure of the program from the JAX package, kept here).

The free-free parts (freefree_kappa, the ds step, the finish) and the
scene and trace building blocks are imported from the other reference
modules, unchanged. Every function takes the dtype it computes in:
float32 as the configuration states, or a lower precision for the
control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import (AU_CM, C_CGS, FB_COEF, FILL_B, FILL_NE, FILL_TE,
                        FPE_COEF, KB_CGS, M_E_G, R_SUN_CM, SFU2CGS)
from .scene import (Grid, finalize_cubes, image_ray_starts, mas_variable,
                    resample_cube)
from .trace import _Stepper, corner_offsets, init_k_vectors, trace_tables, \
    trilinear
from .transfer import (MECH_FREEFREE, MECH_GYRORESONANCE, MECH_NEUTRALS,
                       O_MODE, X_MODE, finish, freefree_kappa,
                       log_spaced_freqs, refractive_index_sq)

# the highest harmonic: GRFF's Parms[7] = 30 in the reference script, and
# the program's record-fold default
S_MAX = 30


# ---------------------------------------------------------------------------
# Scene: the B-vector cubes
# ---------------------------------------------------------------------------

def bvec_image_cubes(br, bt, bp, grid, dtype):
    """Image-frame Cartesian (bx, by, bz) cubes of the resampled spherical
    components: MAS Cartesian is (x, -z, y) of the image frame, with rho =
    sqrt(x^2 + z^2) clamped at 1e-12 on the polar axis."""
    xs, ys, zs = (torch.as_tensor(np.asarray(a, np.float32),
                                  device=br.device).to(dtype)
                  for a in grid.axes())
    x = xs[:, None, None]
    y = ys[None, :, None]
    z = zs[None, None, :]
    r = torch.sqrt(x * x + y * y + z * z)
    rho = torch.sqrt(x * x + z * z)
    r_s = torch.clamp(r, min=1e-12)
    rho_s = torch.clamp(rho, min=1e-12)
    br = torch.nan_to_num(br, nan=0.0)
    bt = torch.nan_to_num(bt, nan=0.0)
    bp = torch.nan_to_num(bp, nan=0.0)
    bx = br * (x / r_s) + bt * (x * y / (r_s * rho_s)) + bp * (z / rho_s)
    by = br * (y / r_s) + bt * (-rho / r_s)
    bz = br * (z / r_s) + bt * (z * y / (r_s * rho_s)) + bp * (-x / rho_s)
    return bx, by, bz


def scene_cubes(arrays, mesh, grid, phi0_offset_deg, device, dtype):
    """{omega_pe, ne, te, b, bvec} cubes of the MAS fields `arrays` on
    `mesh`, resampled onto `grid` (scene.scene_cubes and the B-vector
    triple)."""
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
    return {"omega_pe": omega_pe, "ne": ne, "te": te, "b": b,
            "bvec": bvec_image_cubes(*raw[2:], grid, dtype)}


# ---------------------------------------------------------------------------
# Trace: records with row 7
# ---------------------------------------------------------------------------

def cos_theta_signed(kvec, bv):
    """Signed cos(theta) between B and the wave vector (last axis 3); zero
    B or k gives 0."""
    num = torch.sum(bv * kvec, dim=-1)
    den = (torch.sqrt(torch.sum(bv * bv, dim=-1))
           * torch.sqrt(torch.sum(kvec * kvec, dim=-1)))
    return torch.clamp(num / torch.clamp(den, min=1e-30), -1.0, 1.0)


def sample_table(cubes, dtype):
    """The (N, 8) sample table [ne, te, b, Bx, By, Bz, 0, 0], channels
    last."""
    chans = [cubes["ne"], cubes["te"], cubes["b"], *cubes["bvec"]]
    zero = torch.zeros_like(cubes["ne"])
    return torch.stack([c.to(dtype) for c in chans] + [zero, zero],
                       dim=-1).contiguous().reshape(-1, 8)


def trace_records(cubes, grid, freq_hz, start, kdir, dt, n_steps,
                  record_stride, perturb_ratio=2.0, dtype=torch.float32):
    """trace.trace_records with the 8-channel sample table: records
    (n_records, 8, n), rows [x, y, z, S, ne, te, b, cos_theta] with
    cumulative S."""
    device = cubes["omega_pe"].device
    table, _ = trace_tables(cubes, grid, dtype)
    stable = sample_table(cubes, dtype)
    offs = corner_offsets(grid, device)
    start_t = torch.as_tensor(start, device=device).to(dtype)
    kdir_t = torch.as_tensor(kdir, device=device).to(dtype)
    k0 = init_k_vectors(table, grid, offs, freq_hz, start_t, kdir_t)
    r = start_t.T.contiguous()
    k = k0.T.contiguous()
    cum_s = torch.ones(r.shape[1], dtype=dtype, device=device)
    fills = torch.tensor([FILL_NE, FILL_TE, FILL_B] + [0.0] * 5, dtype=dtype,
                         device=device)
    stepper = _Stepper(table, grid, offs, r, k, np.float32(dt),
                       np.float32(perturb_ratio))
    n_records = -(-n_steps // record_stride)
    recs = []
    for b in range(n_records):
        acc = torch.ones_like(cum_s)
        for _ in range(1 if b == 0 else record_stride):
            acc = acc * stepper.step()
        cum_s = cum_s * acc
        v = trilinear(stable, grid, offs, r[0], r[1], r[2])
        v = torch.where(torch.isfinite(v), v, fills)
        cos_t = cos_theta_signed(k.T, v[:, 3:6])
        recs.append(torch.stack([r[0], r[1], r[2], cum_s, v[:, 0], v[:, 1],
                                 v[:, 2], cos_t]))
    return torch.stack(recs)


# ---------------------------------------------------------------------------
# Physics: thermal gyroresonance
# ---------------------------------------------------------------------------

def gyro_polarization_coupling(X, Y, theta_rad, sigma):
    """The magnetoionic polarization coupling F_sigma(theta) of thermal
    gyroresonance, |e_x - i e_y|^2 / ||e||^2 of the mode's cold-plasma
    polarization, with the Stix S, D, P, A = n^2 - S, d = P - n^2 sin^2:
    F = (A + D)^2 d^2 / (A^2 d^2 + D^2 d^2 + A^2 n^4 cos^2 sin^2)."""
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


def gyroresonance_kappa(ne, te, b, nu, theta_rad, sigma, s_max=S_MAX):
    """Thermal gyroresonance opacity summed over s = 2..s_max [cm^-1]:
    kappa_s = (pi^2/(2c)) (nu_p^2/nu) F_sigma (s^2/s!) (s^2 beta^2
    sin^2/2)^(s-1) s nu_B Gauss(nu - s nu_B; s nu_B beta max(|cos|,
    0.01)), beta^2 = kT/(m c^2), in log space with lgamma, summed over a
    leading harmonic axis in one reduction."""
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


# ---------------------------------------------------------------------------
# Transfer: the voxel update and the record fold
# ---------------------------------------------------------------------------

def make_voxel_update(freqs, pixel_area_cm2, mechanism, s_max, dtype):
    """The voxel update of the mechanism bits (1 free-free, 2
    gyroresonance, 4 neutrals, which count only with free-free), the Dulk
    Coulomb logarithm and theta given per voxel: (carry, ds, te, ne, b,
    mask, sarea, theta) -> carry."""
    device = freqs.device
    include_ff = bool(mechanism & MECH_FREEFREE)
    include_neutrals = bool(mechanism & MECH_NEUTRALS)
    include_gr = bool(mechanism & MECH_GYRORESONANCE)
    area_default = torch.tensor(pixel_area_cm2, dtype=dtype, device=device)
    src_coef = (torch.tensor(KB_CGS / (C_CGS * C_CGS) / SFU2CGS, dtype=dtype,
                             device=device) * (freqs * freqs))
    inv_au = torch.tensor(1.0 / AU_CM, dtype=dtype, device=device)
    inv_au_sq = inv_au * inv_au

    def update(carry, ds_k, te_k, ne_k, b_k, mask_k, sarea_k, theta_k):
        f_o, f_x, t_o, t_x = carry
        theta = theta_k[:, None]
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
            if not include_ff:
                kappa = torch.zeros_like(kappa)
            if include_gr:
                kappa = kappa + gyroresonance_kappa(ne_s, te_s, b_s, nu,
                                                    theta, sigma, s_max)
            tau = torch.where(m, kappa * ds_s, 0.0)
            tau = torch.where(torch.isfinite(tau), tau, 0.0)
            evan = m & (n2 <= 0.0)
            return tau, evan

        tau_p, evan_p = coeffs(O_MODE)
        tau_m, evan_m = coeffs(X_MODE)
        # B against k flips the handedness; the dead zone absorbs the
        # arccos/cos round trip at exactly perpendicular B
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


def record_step(pos, s, prev, scale, usable):
    """One step of the ds scan: (valid, ds in cm, new last valid
    positions); a record is valid only where `usable` holds."""
    valid = (torch.all(torch.isfinite(pos), dim=-1)
             & torch.isfinite(s) & (s > 0.0))
    valid = valid & usable
    p_safe = torch.where(valid[:, None], pos, prev)
    d = torch.sqrt(torch.sum((p_safe - prev) ** 2, dim=-1)) * scale
    return valid, torch.where(valid, d, 0.0), p_safe


def fold_records(recs, start, freqs, pixel_area_cm2, mechanism, s_on, dtype,
                 s_max=S_MAX):
    """Fold every record of `recs` (n_records, 8, n) into the carry from
    the ray starts `start` (n, 3), theta per record from row 7 (a record
    whose row 7 is not finite is not valid): (flux_o, flux_x), each (n,
    Nf)."""
    n, nf = recs.shape[2], freqs.shape[0]
    update = make_voxel_update(freqs, pixel_area_cm2, mechanism, s_max,
                               dtype)
    z = torch.zeros((n, nf), dtype=dtype, device=recs.device)
    carry = (z, z, z, z)
    prev = torch.as_tensor(start, device=recs.device).to(dtype).contiguous()
    area32 = np.float32(pixel_area_cm2)
    scale = np.float32(R_SUN_CM)
    for rec in recs:
        s = rec[3]
        valid, dsv, prev = record_step(rec[0:3].T, s, prev, scale,
                                       torch.isfinite(rec[7]))
        sarea = s * area32 if s_on else torch.zeros_like(s)
        theta_k = torch.arccos(torch.clamp(rec[7], -1.0, 1.0))
        carry = update(carry, dsv, rec[5], rec[4], rec[6], valid, sarea,
                       theta_k)
    return carry[0], carry[1]


# ---------------------------------------------------------------------------
# The map
# ---------------------------------------------------------------------------

def map_pixels(arrays, mesh, run, pixels, device, dtype=torch.float32):
    """(T_b, V/I) of the flat `pixels` (p = i * n_pix + j) of the map of
    `run` (the RayEmissionConfig fields of a map) at any mechanism, with
    theta per record (theta_mode 'los'), each (len(pixels), Nf) float64
    numpy."""
    fixed = dict(theta_mode="los", gaunt="dulk", s_mode="cumulative")
    if any(run.get(k, v) != v for k, v in fixed.items()):
        raise ValueError(f"the gyroresonance reference maps {fixed} only")
    # float32 products stay float32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grid = Grid.cube(run["grid_extent"], run["grid_n"])
    cubes = scene_cubes(arrays, mesh, grid, run["phi0_offset"], device,
                        dtype)
    _, _, start, kdir = image_ray_starts(run["n_pix"], run["x_fov"],
                                         run["z_observer"])
    recs = trace_records(cubes, grid, run["freq_hz"], start[pixels],
                         kdir[pixels], run["dt"], run["n_steps"],
                         run["record_stride"], run["perturb_ratio"], dtype)
    del cubes
    freq0 = run["freq0"] or run["freq_hz"]
    frequencies_hz = log_spaced_freqs(freq0, run["nfreq"],
                                      run["freq_log_step"])
    pixel_size_cm = (2 * run["x_fov"]) / run["n_pix"] * R_SUN_CM
    pixel_area_cm2 = pixel_size_cm * pixel_size_cm
    freqs = torch.as_tensor(frequencies_hz, device=device).to(dtype)
    flux_o, flux_x = fold_records(recs, start[pixels], freqs, pixel_area_cm2,
                                  run["mechanism"], run["s_input_on"], dtype)
    return finish(flux_o, flux_x, frequencies_hz, pixel_area_cm2, dtype)
