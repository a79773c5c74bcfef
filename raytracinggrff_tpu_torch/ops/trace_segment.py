"""One trace segment per ray: the wrapper, the plain version and the build
of the hand-written CUDA kernel (csrc/trace_segment.cu).

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
the gather tables of ops/trilinear.pack_fields. The ray state is (7, n_rays)
rows [x, y, z, kx, ky, kz, cumS].

Dispatch is by device: a CPU tensor runs the plain torch version; a CUDA
tensor launches the kernel or raises. The kernel library is built with
nvcc at first use into raytracinggrff_tpu_torch/_build/, named by a hash
of the sources and flags.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..constants import C_R, FILL_B, FILL_NE, FILL_TE
from ..grids import UniformGrid
from ..tracer import advance_blocks, check_s_mode, cos_theta_signed
from .trilinear import trilinear_packed

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# The shipped build keeps nvcc from contracting a*b+c into FMAs
# (-fmad=false), so it rounds as the plain version's separate torch ops do:
# its records equal theirs bit for bit, over whole traces too (chip_smoke.py
# phase 14 (b)), and the CUDA tests hold it to that. FMA_NVCC_FLAGS lets
# nvcc contract, which takes the canonical segment from 4.95-5.00 to
# 4.18-4.21 ms on an H100 80GB HBM3 at 700 W (profile_slice.py phase cache,
# PERF.md); but over a whole trace some of its rays part from the plain
# version's, and the 256^2 production map then moves outside the map bars
# (phase 14 (c)), so that build serves only for measurement.
FMA_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                  "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                  "-Xptxas", "-v")
NVCC_FLAGS = FMA_NVCC_FLAGS + ("-fmad=false",)
STATE_ROWS = 7
RECORD_ROWS = 8


class _TraceParams(ctypes.Structure):
    """Mirror of struct TraceParams in csrc/trace_segment.cu."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "c_r", "perturb_ratio", "x0", "y0", "z0",
        "inv_dx", "inv_dy", "inv_dz", "fill_ne", "fill_te", "fill_b")] + [
        (name, ctypes.c_int) for name in (
            "nx", "ny", "nz", "n_rays", "n_first", "stride", "rps",
            "crosssections", "sample_channels", "wide_index", "per_step")]


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "trace-segment kernel builds from csrc/ with it")
    return found


def build_library(flags=NVCC_FLAGS):
    """Compile csrc/*.cu with nvcc `flags` into _build/ unless a library of
    the same sources and flags is there already. Returns (path, ptxas
    log)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    tag = h.hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"librgrff_kernels_{tag}.so"
    log = BUILD_DIR / f"librgrff_kernels_{tag}.log"
    if not lib.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *flags, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, (log.read_text() if log.exists() else "")


@functools.cache
def _library():
    """The kernel library, built if needed and loaded once per process."""
    return load_library(build_library()[0])


def load_library(path):
    """Load a library built by build_library and declare its C entries."""
    lib = ctypes.CDLL(str(path))
    lib.rgrff_trace_segment.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, _TraceParams, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.rgrff_trace_segment.restype = ctypes.c_int
    lib.rgrff_cache_counters.argtypes = []
    lib.rgrff_cache_counters.restype = ctypes.c_int
    lib.rgrff_error_string.argtypes = [ctypes.c_int]
    lib.rgrff_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _library()
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
    n_counts = lib.rgrff_cache_counters()
    counts = (torch.zeros(n_counts, dtype=torch.int64, device=state.device)
              if n_counts else None)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rgrff_trace_segment(
            tcube.data_ptr(), scube.data_ptr(), state.data_ptr(),
            state_out.data_ptr(), records.data_ptr(), params,
            None if counts is None else counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("trace-segment kernel launch failed: "
                           + lib.rgrff_error_string(err).decode())
    trace_segment.launches += 1
    if counts is not None:
        prev = trace_segment.cache_counts
        trace_segment.cache_counts = counts if prev is None else prev + counts
    return state_out, records


trace_segment.launches = 0
# [central evaluations, central misses, perturbed evaluations, perturbed
# misses] summed over launches, kept only by a library built with
# -DRGRFF_COUNT_CACHE (profile_slice.py); None otherwise
trace_segment.cache_counts = None


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
