"""The plain reference of the refractive trace: the records of a set of
rays traced through the cubes, in plain torch.

A frozen copy of the port's plain trace (raytracinggrff_tpu_torch/
tracer.py, ops/trilinear.py, tracer_segments.prepare_trace_inputs and
initial_state, ops/trace_segment.trace_segment_plain), computing every
value with the same operations in the same order, so that in float32 on
a card its records equal the plain version's, which the trace kernel
equals bit for bit in rows 0-6. Two things are arranged for speed and
change no value, since each is elementwise or a gather:

  * the eight corner gathers of a trilinear sample are one index_select,
    and its seven lerps run as three batched lerps in the same order;
  * the two perturbed RK4 steps of a cross-section step run as one RK4
    step over both sets of rays side by side.

On a CUDA device one step runs as a captured CUDA graph of those torch
operations, replayed step after step: the step is some 700 small
launches, and the graph removes their host cost.

Records are (n_records, 8, n_rays), rows [x, y, z, S, ne, te, b,
cos_theta] with cumulative S; row 7 is 0 (no B-vector cubes).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .constants import C_R, FILL_B, FILL_NE, FILL_TE


def gradient_cubes(f, grid):
    """np.gradient-compatible central differences, one-sided at the
    edges, in the dtype of `f`."""
    def grad_axis(h, axis):
        central = (torch.roll(f, -1, axis) - torch.roll(f, 1, axis)) / (2.0 * h)
        n = f.shape[axis]
        first = (f.narrow(axis, 1, 1) - f.narrow(axis, 0, 1)) / h
        last = (f.narrow(axis, n - 1, 1) - f.narrow(axis, n - 2, 1)) / h
        return torch.cat([first, central.narrow(axis, 1, n - 2), last],
                         dim=axis)

    return (grad_axis(grid.dx, 0), grad_axis(grid.dy, 1),
            grad_axis(grid.dz, 2))


def trace_tables(cubes, grid, dtype):
    """(trace table (N, 4) = [omega_pe, d/dx, d/dy, d/dz], sample table
    (N, 4) = [ne, te, b, 0]) of the cubes, channels last."""
    wpe = cubes["omega_pe"].to(dtype)
    tcube = torch.stack([wpe, *gradient_cubes(wpe, grid)], dim=-1)
    zero = torch.zeros_like(wpe)
    scube = torch.stack([cubes[k].to(dtype) for k in ("ne", "te", "b")]
                        + [zero], dim=-1)
    return tcube.contiguous().reshape(-1, 4), scube.contiguous().reshape(-1, 4)


def _corner_weights(grid, px, py, pz):
    """Base corner flat index, trilinear weights and the in-bounds mask."""
    inv_dx, inv_dy, inv_dz = grid.inv_steps
    fx = (px - grid.x0) * inv_dx
    fy = (py - grid.y0) * inv_dy
    fz = (pz - grid.z0) * inv_dz

    nx, ny, nz = grid.shape
    inb = ((fx >= 0.0) & (fy >= 0.0) & (fz >= 0.0)
           & (fx <= nx - 1) & (fy <= ny - 1) & (fz <= nz - 1))

    i0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, nx - 2)
    j0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, ny - 2)
    k0 = torch.clamp(torch.floor(fz).to(torch.int64), 0, nz - 2)

    tx = torch.clamp(fx - i0.to(fx.dtype), 0.0, 1.0)
    ty = torch.clamp(fy - j0.to(fy.dtype), 0.0, 1.0)
    tz = torch.clamp(fz - k0.to(fz.dtype), 0.0, 1.0)

    base = (i0 * ny + j0) * nz + k0
    return base, tx, ty, tz, inb


def corner_offsets(grid, device):
    """Flat offsets of a cell's corners, in the order 000, 100, 010, 110,
    001, 101, 011, 111 (x fastest)."""
    sx, sy = grid.ny * grid.nz, grid.nz
    return torch.tensor([0, sx, sy, sx + sy, 1, sx + 1, sy + 1,
                         sx + sy + 1], dtype=torch.int64, device=device)


def trilinear(packed, grid, offs, px, py, pz):
    """Sample a packed (N, C) table at positions (n,) each: (n, C) values,
    NaN out of the cube."""
    base, tx, ty, tz, inb = _corner_weights(grid, px, py, pz)
    base = torch.where(inb, base, 0)
    n = base.shape[0]
    c = packed.index_select(0, (base[:, None] + offs).reshape(-1))
    c = c.reshape(n, 8, packed.shape[1])
    tx = tx[:, None, None]
    ty = ty[:, None, None]
    tz = tz[:, None]
    # x: (000,100) (010,110) (001,101) (011,111) -> c00 c10 c01 c11
    cx = c[:, 0::2] * (1.0 - tx) + c[:, 1::2] * tx
    # y: (c00,c10) (c01,c11) -> c0 c1
    cy = cx[:, 0::2] * (1.0 - ty) + cx[:, 1::2] * ty
    v = cy[:, 0] * (1.0 - tz) + cy[:, 1] * tz
    return torch.where(inb[:, None], v, math.nan)


def _rhs(table, grid, offs, r, k):
    """ODE right-hand side; r, k: (3, n). Returns (dr, dk)."""
    v = trilinear(table, grid, offs, r[0], r[1], r[2])
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


def _rk4_step(table, grid, offs, r, k, dt):
    k1r, k1k = _rhs(table, grid, offs, r, k)
    k2r, k2k = _rhs(table, grid, offs, r + 0.5 * dt * k1r, k + 0.5 * dt * k1k)
    k3r, k3k = _rhs(table, grid, offs, r + 0.5 * dt * k2r, k + 0.5 * dt * k2k)
    k4r, k4k = _rhs(table, grid, offs, r + dt * k3r, k + dt * k3k)
    c = dt / 6.0
    r_new = r + c * (k1r + 2.0 * k2r + 2.0 * k3r + k4r)
    k_new = k + c * (k1k + 2.0 * k2k + 2.0 * k3k + k4k)
    return r_new, k_new


def _transverse_basis(t_hat):
    """Transverse unit vectors e1, e2 of step directions t_hat (3, n)."""
    use_z = torch.abs(t_hat[2]) < 0.9
    ax = torch.zeros_like(t_hat[0])
    one = torch.ones_like(ax)        # 0 and 1 in the dtype of the trace
    ay = torch.where(use_z, ax, one)
    az = torch.where(use_z, one, ax)
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


def crosssection_step(table, grid, offs, r, k, dt, perturb_ratio):
    """One RK4 step plus its cross-section ratio: (r, k, S ratio)."""
    r_new, k_new = _rk4_step(table, grid, offs, r, k, dt)
    r_diff = r_new - r
    dnorm = torch.sqrt(torch.sum(r_diff * r_diff, dim=0)) + 1e-32
    t_hat = r_diff / dnorm[None, :]
    e1, e2 = _transverse_basis(t_hat)
    eps = perturb_ratio * dnorm

    n = r.shape[1]
    pair, _ = _rk4_step(
        table, grid, offs,
        torch.cat([r + eps[None, :] * e1, r + eps[None, :] * e2], dim=1),
        torch.cat([k, k], dim=1), dt)
    r1, r2 = pair[:, :n], pair[:, n:]

    d1 = r1 - r_new
    d2 = r2 - r_new
    cx = d1[1] * d2[2] - d1[2] * d2[1]
    cy = d1[2] * d2[0] - d1[0] * d2[2]
    cz = d1[0] * d2[1] - d1[1] * d2[0]
    num = torch.abs(cx * t_hat[0] + cy * t_hat[1] + cz * t_hat[2])
    s_ratio = num / (eps * eps + 1e-30)
    return r_new, k_new, s_ratio


def init_k_vectors(table, grid, offs, freq_hz, start, kdir):
    """Initial wave vectors kdir * sqrt(max(omega0^2 - omega_pe^2, 0));
    start, kdir (n, 3). Only channel 0 of `table` is read."""
    v = trilinear(table[:, :1], grid, offs, start[:, 0], start[:, 1],
                  start[:, 2])
    wpe0 = torch.nan_to_num(v[:, 0], nan=0.0, posinf=0.0, neginf=0.0)
    omega0 = np.float32(2.0 * np.pi * freq_hz)
    kc0 = torch.sqrt(torch.clamp(omega0 * omega0 - wpe0 * wpe0, min=0.0))
    return kdir * kc0[:, None]


class _Stepper:
    """crosssection_step on fixed tensors r, k: eagerly, or on a CUDA
    device as a captured graph replayed each step."""

    def __init__(self, table, grid, offs, r, k, dt, perturb_ratio):
        self.r, self.k = r, k

        def body():
            return crosssection_step(table, grid, offs, self.r, self.k, dt,
                                     perturb_ratio)

        self.graph = None
        self.body = body
        if r.device.type == "cuda":
            side = torch.cuda.Stream(r.device)
            side.wait_stream(torch.cuda.current_stream(r.device))
            with torch.cuda.stream(side):
                body()                        # reads r, k; writes nothing
            torch.cuda.current_stream(r.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = body()

    def step(self):
        """Advance r and k one step in place; returns the step's S
        ratio."""
        if self.graph is None:
            r_new, k_new, s_ratio = self.body()
        else:
            self.graph.replay()
            r_new, k_new, s_ratio = self.out
        self.r.copy_(r_new)
        self.k.copy_(k_new)
        return s_ratio


def trace_records(cubes, grid, freq_hz, start, kdir, dt, n_steps,
                  record_stride, perturb_ratio=2.0, dtype=torch.float32):
    """Records (n_records, 8, n) of rays starting at `start` with
    directions `kdir` ((n, 3) float32 numpy), traced with cross-sections
    through `cubes` on `grid`: the first record after one step, then one
    every record_stride steps, n_records = ceil(n_steps / record_stride).
    Runs on the device of the cubes, in `dtype`."""
    device = cubes["omega_pe"].device
    table, stable = trace_tables(cubes, grid, dtype)
    offs = corner_offsets(grid, device)
    start_t = torch.as_tensor(start, device=device).to(dtype)
    kdir_t = torch.as_tensor(kdir, device=device).to(dtype)
    k0 = init_k_vectors(table, grid, offs, freq_hz, start_t, kdir_t)
    r = start_t.T.contiguous()
    k = k0.T.contiguous()
    cum_s = torch.ones(r.shape[1], dtype=dtype, device=device)
    fills = torch.tensor([FILL_NE, FILL_TE, FILL_B, 0.0], dtype=dtype,
                         device=device)
    zero = torch.zeros_like(cum_s)
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
        recs.append(torch.stack([r[0], r[1], r[2], cum_s, v[:, 0], v[:, 1],
                                 v[:, 2], zero]))
    return torch.stack(recs)
