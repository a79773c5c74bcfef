"""One trace segment per ray, and the kernel's input cubes: the wrappers,
the plain versions and the build of the hand-written CUDA kernels
(csrc/trace_segment.cu).

The kernel replaces the Pallas TPU kernel
raytracinggrff_tpu/ops/pallas_trace.py::_make_kernel (launched by
run_trace_segment, pallas_call at ops/pallas_trace.py:654). A segment
advances every ray `n_first + (rps-1)*stride` RK4 steps with cross-section
tracking and writes `rps` records of 8 rows [x, y, z, S, ne, te, b,
cos_theta] per ray, in the serial order of the JAX XLA tracer
(tracer.py:93-287). Row 3 holds the running product of the step ratios
(s_mode='cumulative') or the ratio of the record's last step
(s_mode='per_step', tracer.py:235-266); the state carries the running
product in both modes.

Inputs are channels-last float32 cubes: the trace cube (nx, ny, nz, 4) holds
[omega_pe, d/dx, d/dy, d/dz] and the sample cube (nx, ny, nz, 4 or 8) holds
[ne, te, b, 0] or [ne, te, b, Bx, By, Bz, 0, 0]; reshaped to (N, C) they are
the gather tables of ops/trilinear.pack_fields. pack_trace_inputs builds both
from the (nx, ny, nz) cubes in one launch (rgrff_pack_trace_inputs): the
gradients and the channels-last layout that plain torch makes with rolls,
cats and stacks. The ray state is (7, n_rays) rows [x, y, z, kx, ky, kz,
cumS].

Dispatch is by device: a CPU tensor runs the plain torch version; a CUDA
tensor launches the kernel or raises; each wrapper counts its launches in
its `launches` attribute. The kernel library (ops/_build.py)
is built with nvcc at first use into raytracinggrff_tpu_torch/_build/,
named by a hash of the sources and flags.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import C_R, FILL_B, FILL_NE, FILL_TE
from ..grids import UniformGrid
from ..tracer import (advance_blocks, check_s_mode, cos_theta_signed,
                      gradient_cubes)
from . import _build
from ._build import _PackParams, _TraceParams
from .trilinear import trilinear_packed

STATE_ROWS = 7
RECORD_ROWS = 8


def grid_param_vec(grid: UniformGrid):
    """[x0, y0, z0, 1/dx, 1/dy, 1/dz] as float32, the values the torch
    sampler's Python-float arithmetic rounds to (ops/pallas_trace.py:602)."""
    return np.concatenate([np.asarray(grid.origin, np.float32),
                           np.asarray(grid.inv_steps, np.float32)])


def needs_wide_index(n_voxels, sample_channels):
    """Whether the sample cube, the larger of the two, holds 2^31 float4
    or more, so that the kernel needs 64-bit cube offsets."""
    return n_voxels * (sample_channels // 4) >= 2 ** 31


def _check(tcube, scube, state, grid, n_first, stride, rps):
    for name, t in (("tcube", tcube), ("scube", scube), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != state.device:
            raise ValueError(f"{name} is on {t.device}, state on "
                             f"{state.device}")
    if tuple(tcube.shape) != (*grid.shape, 4):
        raise ValueError(f"tcube shape {tuple(tcube.shape)} != "
                         f"{(*grid.shape, 4)}")
    if tuple(scube.shape[:3]) != grid.shape or scube.shape[3] not in (4, 8):
        raise ValueError(f"scube shape {tuple(scube.shape)} must be "
                         f"{grid.shape} + (4 or 8,)")
    if state.ndim != 2 or state.shape[0] != STATE_ROWS:
        raise ValueError(f"state must be ({STATE_ROWS}, n_rays), got "
                         f"{tuple(state.shape)}")
    if min(grid.shape) < 2:
        raise ValueError(f"grid {grid.shape} needs >= 2 nodes per axis")
    if min(n_first, stride, rps) < 1:
        raise ValueError(f"n_first={n_first}, stride={stride}, rps={rps} "
                         f"must be >= 1")


def trace_segment(tcube, scube, state, grid: UniformGrid, dt, n_first,
                  stride, rps, perturb_ratio=2.0, crosssections=True,
                  s_mode="cumulative"):
    """Advance every ray of `state` one segment; returns (state_out,
    records) with records (rps, 8, n_rays). CPU tensors run
    trace_segment_plain; CUDA tensors launch the kernel."""
    _check(tcube, scube, state, grid, n_first, stride, rps)
    check_s_mode(s_mode)
    if state.device.type == "cpu":
        return trace_segment_plain(tcube, scube, state, grid, dt, n_first,
                                   stride, rps, perturb_ratio, crosssections,
                                   s_mode)
    if state.device.type != "cuda":
        raise ValueError(f"no trace-segment kernel for {state.device}")
    n_rays = state.shape[1]
    if n_rays >= 2 ** 31:
        raise ValueError(f"{n_rays} rays exceed the kernel's int range")
    lib = _build.library()
    state_out = torch.empty_like(state)
    records = torch.empty((rps, RECORD_ROWS, n_rays), dtype=torch.float32,
                          device=state.device)
    g = grid_param_vec(grid)
    channels = scube.shape[3]
    params = _TraceParams(
        float(np.float32(dt)), float(np.float32(C_R)),
        float(np.float32(perturb_ratio)), *map(float, g),
        FILL_NE, FILL_TE, FILL_B, grid.nx, grid.ny, grid.nz, n_rays,
        n_first, stride, rps, int(bool(crosssections)), channels,
        int(needs_wide_index(grid.nx * grid.ny * grid.nz, channels)),
        int(s_mode == "per_step"))
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rgrff_trace_segment(
            tcube.data_ptr(), scube.data_ptr(), state.data_ptr(),
            state_out.data_ptr(), records.data_ptr(), params, stream)
    if err != 0:
        raise RuntimeError("trace-segment kernel launch failed: "
                           + lib.rgrff_error_string(err).decode())
    trace_segment.launches += 1
    return state_out, records


trace_segment.launches = 0


def trace_segment_plain(tcube, scube, state, grid: UniformGrid, dt, n_first,
                        stride, rps, perturb_ratio=2.0, crosssections=True,
                        s_mode="cumulative"):
    """The kernel's computation in plain torch (tracer.py building blocks
    and trilinear_packed), on any device; same signature and outputs."""
    check_s_mode(s_mode)
    per_step = s_mode == "per_step"
    table = tcube.reshape(-1, 4)
    stable = scube.reshape(-1, scube.shape[3])
    fills = torch.tensor([FILL_NE, FILL_TE, FILL_B]
                         + [0.0] * (stable.shape[1] - 3),
                         dtype=torch.float32, device=state.device)
    r, k, cum_s = state[0:3], state[3:6], state[6]
    recs = []
    for r, k, cum_s, last in advance_blocks(
            table, grid, r, k, cum_s, np.float32(dt), n_first, stride, rps,
            crosssections, np.float32(perturb_ratio)):
        v, _ = trilinear_packed(stable, grid, r[0], r[1], r[2])
        v = torch.where(torch.isfinite(v), v, fills)
        if stable.shape[1] == 8:
            cos_t = cos_theta_signed(k.T, v[:, 3:6])
        else:
            cos_t = torch.zeros_like(cum_s)
        s = last if per_step and crosssections else cum_s
        recs.append(torch.stack([r[0], r[1], r[2], s, v[:, 0], v[:, 1],
                                 v[:, 2], cos_t]))
    state_out = torch.cat([r, k, cum_s[None]])
    return state_out, torch.stack(recs)


def pack_param_vec(grid: UniformGrid):
    """[1/(2 dx), 1/(2 dy), 1/(2 dz), 1/dx, 1/dy, 1/dz] as float32: the
    reciprocals by which torch's CUDA division of a float32 tensor by the
    Python floats 2.0*h and h multiplies (div_true_kernel_cuda), each
    taken in float64 and rounded once to float32."""
    steps = (grid.dx, grid.dy, grid.dz)
    return np.asarray([1.0 / (2.0 * h) for h in steps]
                      + [1.0 / h for h in steps], np.float32)


def _check_pack(cubes, grid):
    device = cubes[0].device
    for name, c in zip(("omega_pe", "ne", "te", "b", "bx", "by", "bz"),
                       cubes):
        if tuple(c.shape) != grid.shape:
            raise ValueError(f"{name} cube shape {tuple(c.shape)} != grid "
                             f"{grid.shape}")
        if c.device != device:
            raise ValueError(f"{name} cube is on {c.device}, omega_pe on "
                             f"{device}")
    if min(grid.shape) < 2:
        raise ValueError(f"grid {grid.shape} needs >= 2 nodes per axis")


def pack_trace_inputs(omega_pe_cube, ne_cube, te_cube, b_cube,
                      grid: UniformGrid, bvec=None):
    """(tcube, scube): the trace cube (nx, ny, nz, 4) = [omega_pe, d/dx,
    d/dy, d/dz] and the sample cube (nx, ny, nz, 4) = [ne, te, b, 0], or
    (nx, ny, nz, 8) = [ne, te, b, Bx, By, Bz, 0, 0] with `bvec` (three
    cubes), float32 and contiguous, from (nx, ny, nz) tensors on one
    device. CPU tensors run pack_trace_inputs_plain; CUDA tensors launch
    rgrff_pack_trace_inputs once, which equals it bit for bit."""
    cubes = [omega_pe_cube, ne_cube, te_cube, b_cube]
    if bvec is not None:
        if len(bvec) != 3:
            raise ValueError(f"bvec must hold 3 cubes, got {len(bvec)}")
        cubes += list(bvec)
    _check_pack(cubes, grid)
    device = omega_pe_cube.device
    if device.type == "cpu":
        return pack_trace_inputs_plain(omega_pe_cube, ne_cube, te_cube,
                                       b_cube, grid, bvec)
    if device.type != "cuda":
        raise ValueError(f"no trace-input kernel for {device}")
    cubes = [c.to(torch.float32).contiguous() for c in cubes]
    channels = 4 if bvec is None else 8
    tcube = torch.empty((*grid.shape, 4), dtype=torch.float32, device=device)
    scube = torch.empty((*grid.shape, channels), dtype=torch.float32,
                        device=device)
    params = _PackParams(*map(float, pack_param_vec(grid)), *grid.shape,
                         channels)
    ptrs = [c.data_ptr() for c in cubes] + [None] * (7 - len(cubes))
    _build.launch("rgrff_pack_trace_inputs", device, *ptrs,
                  tcube.data_ptr(), scube.data_ptr(), params)
    pack_trace_inputs.launches += 1
    return tcube, scube


pack_trace_inputs.launches = 0


def pack_trace_inputs_plain(omega_pe_cube, ne_cube, te_cube, b_cube,
                            grid: UniformGrid, bvec=None):
    """The kernel's computation in plain torch (tracer.gradient_cubes,
    torch.stack), on any device; same signature and outputs."""
    wpe = omega_pe_cube.to(torch.float32)
    tcube = torch.stack([wpe, *gradient_cubes(wpe, grid)], dim=-1)
    channels = [ne_cube, te_cube, b_cube]
    if bvec is not None:
        channels += list(bvec)
    nch = 4 if bvec is None else 8
    zero = torch.zeros_like(wpe)
    channels += [zero] * (nch - len(channels))
    scube = torch.stack([c.to(torch.float32) for c in channels], dim=-1)
    return tcube.contiguous(), scube.contiguous()
