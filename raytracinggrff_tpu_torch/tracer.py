"""Refractive ray tracing through a plasma-frequency cube, in plain torch.

Physics (build_rays.py:128-248):
    dr/dt = C_R * k / omega
    dk/dt = -(omega_pe / omega) * grad(omega_pe) * C_R
    omega^2 = omega_pe^2 + |k|^2        (k in angular-frequency units)
with positions in R_sun and time in seconds, integrated with RK4. An
evaluation that samples outside the cube (or NaN) gets dr = 0, which freezes
the ray (build_rays.py:169-175).

Cross-sections (build_rays.py:186-244): per step, two rays perturbed
transversely by eps = perturb_ratio*|dr| advance one step from the central
ray's previous state; S = |cross(d1, d2) . t_hat| / eps^2. Records carry the
cumulative product of S (s_mode='cumulative', the GPU reference,
gpu_raytrace.py:398-408) or the ratio of the record's last step
(s_mode='per_step', the CPU reference, build_rays.py:241-244).

These functions are the building blocks of the trace-segment kernel's plain
version (ops/trace_segment.py); `trace_rays` is the twin of the JAX
package's XLA tracer and serves the tests. State is laid out (3, n_rays).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np
import torch

from .constants import C_R
from .grids import UniformGrid
from .ops.trilinear import pack_fields, trilinear_packed


class TraceResult(NamedTuple):
    r_record: torch.Tensor       # (n_records, n_rays, 3) recorded positions
    s_record: torch.Tensor       # (n_records, n_rays) S of the s_mode
    final_state: torch.Tensor    # (n_rays, 6) final [r, k]
    k_record: torch.Tensor | None = None  # (n_records, n_rays, 3)


def gradient_cubes(cube, grid: UniformGrid):
    """np.gradient-compatible central differences, one-sided at the edges
    (build_rays.py:136-138)."""
    f = torch.as_tensor(cube, dtype=torch.float32)

    def grad_axis(h, axis):
        central = (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2.0 * h)
        n = f.shape[axis]
        first = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)) / h
        last = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)) / h
        return torch.cat([first, central.narrow(axis, 1, n - 2), last],
                         dim=axis)

    return (grad_axis(grid.dx, 0), grad_axis(grid.dy, 1),
            grad_axis(grid.dz, 2))


def pack_trace_table(omega_pe_cube, grid: UniformGrid):
    """omega_pe and its three gradients as one (N, 4) gather table."""
    gx, gy, gz = gradient_cubes(omega_pe_cube, grid)
    return pack_fields(omega_pe_cube, gx, gy, gz)


def _rhs(table, grid, r, k):
    """ODE right-hand side; r, k: (3, n_rays). Returns (dr, dk).

    An invalid sample (out of the cube, non-finite, or omega = 0) zeroes dr.
    dk is -(wpe/omega) C_R grad with the gradient zeroed, which is NaN where
    wpe itself is NaN (out of the cube): the ray's k goes NaN and every
    later evaluation is invalid, so the ray stays frozen (rhs_eval,
    gpu_raytrace.py:160-198, as the JAX tracer computes it)."""
    v, _ = trilinear_packed(table, grid, r[0], r[1], r[2])
    wpe = v[:, 0]
    g = v[:, 1:4].T
    k_sq = torch.sum(k * k, dim=0)
    om = torch.sqrt(torch.clamp(wpe * wpe + k_sq, min=0.0))
    valid = (torch.isfinite(wpe) & torch.isfinite(om) & (om > 0.0)
             & torch.all(torch.isfinite(g), dim=0))
    inv_om = torch.where(valid, 1.0 / torch.where(om > 0, om, 1.0), 0.0)
    dr = (C_R * inv_om)[None, :] * k
    dk = (-wpe * inv_om * C_R)[None, :] * torch.where(valid[None, :], g, 0.0)
    dr = torch.where(valid[None, :], dr, 0.0)
    return dr, dk


def _rk4_step(table, grid, r, k, dt):
    k1r, k1k = _rhs(table, grid, r, k)
    k2r, k2k = _rhs(table, grid, r + 0.5 * dt * k1r, k + 0.5 * dt * k1k)
    k3r, k3k = _rhs(table, grid, r + 0.5 * dt * k2r, k + 0.5 * dt * k2k)
    k4r, k4k = _rhs(table, grid, r + dt * k3r, k + dt * k3k)
    c = dt / 6.0
    r_new = r + c * (k1r + 2.0 * k2r + 2.0 * k3r + k4r)
    k_new = k + c * (k1k + 2.0 * k2k + 2.0 * k3k + k4k)
    return r_new, k_new


def _transverse_basis(t_hat):
    """Transverse unit vectors e1, e2 for step directions t_hat (3, n):
    reference axis z where |t_z| < 0.9, else y (build_rays.py:188-201)."""
    use_z = torch.abs(t_hat[2]) < 0.9
    ax = torch.zeros_like(t_hat[0])
    ay = torch.where(use_z, 0.0, 1.0)
    az = torch.where(use_z, 1.0, 0.0)
    e1 = torch.stack([
        ay * t_hat[2] - az * t_hat[1],
        az * t_hat[0] - ax * t_hat[2],
        ax * t_hat[1] - ay * t_hat[0],
    ])
    e1 = e1 / (torch.sqrt(torch.sum(e1 * e1, dim=0)) + 1e-30)[None, :]
    e2 = torch.stack([
        t_hat[1] * e1[2] - t_hat[2] * e1[1],
        t_hat[2] * e1[0] - t_hat[0] * e1[2],
        t_hat[0] * e1[1] - t_hat[1] * e1[0],
    ])
    e2 = e2 / (torch.sqrt(torch.sum(e2 * e2, dim=0)) + 1e-30)[None, :]
    return e1, e2


def _step_with_crosssection(table, grid, r, k, dt, perturb_ratio):
    """One RK4 step plus the per-step cross-section ratio (3 advances)."""
    r_new, k_new = _rk4_step(table, grid, r, k, dt)
    r_diff = r_new - r
    dnorm = torch.sqrt(torch.sum(r_diff * r_diff, dim=0)) + 1e-32
    t_hat = r_diff / dnorm[None, :]
    e1, e2 = _transverse_basis(t_hat)
    eps = perturb_ratio * dnorm

    r1, _ = _rk4_step(table, grid, r + eps[None, :] * e1, k, dt)
    r2, _ = _rk4_step(table, grid, r + eps[None, :] * e2, k, dt)

    d1 = r1 - r_new
    d2 = r2 - r_new
    cx = d1[1] * d2[2] - d1[2] * d2[1]
    cy = d1[2] * d2[0] - d1[0] * d2[2]
    cz = d1[0] * d2[1] - d1[1] * d2[0]
    num = torch.abs(cx * t_hat[0] + cy * t_hat[1] + cz * t_hat[2])
    s_ratio = num / (eps * eps + 1e-30)
    return r_new, k_new, s_ratio


def init_k_vectors(table, grid: UniformGrid, freq_hz, start, kdir):
    """Initial wave vectors kdir * sqrt(max(omega0^2 - omega_pe(start)^2,
    0)); start, kdir: (n_rays, 3) tensors. A NaN or out-of-cube omega_pe
    at the start counts as 0 (gpu_raytrace.py:362-370). Only channel 0 of
    `table` is read."""
    v, _ = trilinear_packed(table[:, :1], grid,
                            start[:, 0], start[:, 1], start[:, 2])
    wpe0 = torch.nan_to_num(v[:, 0], nan=0.0, posinf=0.0, neginf=0.0)
    omega0 = np.float32(2.0 * np.pi * freq_hz)
    kc0 = torch.sqrt(torch.clamp(omega0 * omega0 - wpe0 * wpe0, min=0.0))
    return kdir * kc0[:, None]


S_MODES = ("cumulative", "per_step")


def check_s_mode(s_mode):
    if s_mode not in S_MODES:
        raise ValueError(f"unknown s_mode {s_mode!r}; expected one of "
                         f"{S_MODES}")


def advance_blocks(table, grid, r, k, cum_s, dt, n_first, stride, n_blocks,
                   trace_crosssections=True, perturb_ratio=2.0
                   ) -> Iterator[tuple]:
    """Advance (r, k, cum_s) block by block and yield (r, k, cum_s, last)
    at each record: the first record after `n_first` steps, then one every
    `stride` steps (build_rays.py:204,241). Each block's S product starts
    at 1 and multiplies into cum_s at the record, the order of the JAX
    tracer; `last` is the ratio of the block's last step (1 without
    cross-sections). dt and perturb_ratio are float32 numbers."""
    for b in range(n_blocks):
        acc = torch.ones_like(cum_s)
        last = acc
        for _ in range(n_first if b == 0 else stride):
            if trace_crosssections:
                r, k, last = _step_with_crosssection(table, grid, r, k, dt,
                                                     perturb_ratio)
                acc = acc * last
            else:
                r, k = _rk4_step(table, grid, r, k, dt)
        if trace_crosssections:
            cum_s = cum_s * acc
        yield r, k, cum_s, last


def trace_rays(table, grid: UniformGrid, freq_hz, start, kdir, dt: float,
               n_steps: int, record_stride: int = 10,
               trace_crosssections: bool = False, perturb_ratio: float = 2.0,
               s_mode: str = "cumulative", first_block: int = 1, k_init=None,
               record_k: bool = False) -> TraceResult:
    """Trace all rays for n_steps and record every record_stride steps.

    `table` is pack_trace_table(omega_pe_cube, grid); start, kdir are
    (n_rays, 3) tensors. `first_block`/`k_init` continue a trace: the first
    record comes after `first_block` steps, and `k_init` (n_rays, 3)
    replaces the kc0 initialisation. Callers with first_block != 1 pass
    n_steps = first_block + (n_records-1)*record_stride. s_mode picks
    what the S records hold: the running product ('cumulative') or the
    ratio of each record's last step ('per_step').
    """
    check_s_mode(s_mode)
    per_step = s_mode == "per_step"
    n_records = -(-n_steps // record_stride)
    start = torch.as_tensor(start, dtype=torch.float32)
    kdir = torch.as_tensor(kdir, dtype=torch.float32, device=start.device)
    if k_init is None:
        k0 = init_k_vectors(table, grid, freq_hz, start, kdir)
    else:
        k0 = torch.as_tensor(k_init, dtype=torch.float32, device=start.device)
    r = start.T.contiguous()
    k = k0.T.contiguous()
    ones = torch.ones(r.shape[1], dtype=torch.float32, device=r.device)

    rs, ss, ks = [], [], []
    for r, k, cum_s, last in advance_blocks(
            table, grid, r, k, ones, np.float32(dt), first_block,
            record_stride, n_records, trace_crosssections,
            np.float32(perturb_ratio)):
        rs.append(r.T)
        ss.append(last if per_step else cum_s)
        ks.append(k.T)
    s_record = torch.stack(ss)
    if not trace_crosssections:
        s_record = torch.ones_like(s_record)
    return TraceResult(torch.stack(rs), s_record, torch.cat([r.T, k.T], 1),
                       torch.stack(ks) if record_k else None)


def trace_rays_from_cube(omega_pe_cube, x_grid, y_grid, z_grid, freq_hz,
                         x_start, y_start, z_start, kvec_in_norm, dt,
                         n_steps, record_stride=10, trace_crosssections=False,
                         perturb_ratio=2.0, s_mode="cumulative",
                         device="cuda"):
    """Reference-signature wrapper (trace_ray, gpu_raytrace.py:414-470) on
    `device`, through tracer_segments.iter_trace_segments (the kernel on
    a CUDA device). omega_pe_cube (NaN read as 0) on the uniform
    x/y/z_grid axes, ray starts as three (n_rays,) arrays, kvec_in_norm
    (n_rays, 3).
    Returns (r_record (n_records, n_rays, 3), s_record (n_records,
    n_rays)) as tensors on `device`."""
    from .tracer_segments import iter_trace_segments  # it imports tracer
    grid = UniformGrid.from_arrays(x_grid, y_grid, z_grid)
    cube = torch.nan_to_num(torch.as_tensor(
        np.asarray(omega_pe_cube, np.float32), device=device))
    start = np.column_stack([np.asarray(a, np.float32)
                             for a in (x_start, y_start, z_start)])
    zero = torch.zeros_like(cube)
    recs = torch.cat(list(iter_trace_segments(
        cube, zero, zero, zero, grid, float(freq_hz), start,
        np.asarray(kvec_in_norm, np.float32), float(dt), int(n_steps),
        int(record_stride), bool(trace_crosssections),
        float(perturb_ratio), s_mode=s_mode)))
    return recs[:, 0:3].transpose(1, 2), recs[:, 3]


def cos_theta_signed(kvec, bv):
    """Signed cos(theta) between the sampled B vector and the wave vector
    (last axis 3). Zero B or k gives 0, the theta = 90 fallback."""
    num = torch.sum(bv * kvec, dim=-1)
    den = (torch.sqrt(torch.sum(bv * bv, dim=-1))
           * torch.sqrt(torch.sum(kvec * kvec, dim=-1)))
    return torch.clamp(num / torch.clamp(den, min=1e-30), -1.0, 1.0)

