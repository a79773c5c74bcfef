"""The kernel library of csrc/: its nvcc build, its loading and its C
interface.

Every csrc/*.cu file is compiled by one nvcc call into one shared library
with a plain C interface, built at first use into
raytracinggrff_tpu_torch/_build/ (git-ignored) and named by a hash of the
sources and flags, then loaded with ctypes. The parameter structs mirror
those of the sources: _TraceParams and _PackParams for
csrc/trace_segment.cu, _FoldParams for csrc/transfer_fold.cu, whose
harmonic tables _harmonic_tables builds, _SphParams for
csrc/resample_sph.cu, _ScanParams and _DemParams for csrc/los_scans.cu.
launch() calls a C entry on the current stream and raises on its error
code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# -fmad=false keeps nvcc from contracting a*b+c into FMAs, so the build
# rounds as the plain version's separate torch ops do. Contraction was
# faster, but some rays of a whole trace then parted from the plain
# version's and the production map moved outside its bars (PERF.md).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-fmad=false")


class _TraceParams(ctypes.Structure):
    """Mirror of struct TraceParams in csrc/trace_segment.cu."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "c_r", "perturb_ratio", "x0", "y0", "z0",
        "inv_dx", "inv_dy", "inv_dz", "fill_ne", "fill_te", "fill_b")] + [
        (name, ctypes.c_int) for name in (
            "nx", "ny", "nz", "n_rays", "n_first", "stride", "rps",
            "crosssections", "sample_channels", "wide_index", "per_step")]


class _PackParams(ctypes.Structure):
    """Mirror of struct PackParams in csrc/trace_segment.cu."""
    _fields_ = [(name, ctypes.c_float) for name in (
        "inv_2dx", "inv_2dy", "inv_2dz", "inv_dx", "inv_dy", "inv_dz")] + [
        (name, ctypes.c_int) for name in ("nx", "ny", "nz", "sample_channels")]


FOLD_INT_FIELDS = ("n_rays", "nf", "n_steps", "mechanism", "gaunt_exact",
                   "s_max", "theta_per_voxel", "s_on", "group")
FOLD_FLOAT_FIELDS = (
    "theta0", "area", "inv_au_sq", "r_sun_cm", "src_coef", "fpe_sq", "fb",
    "kappa_ff", "kappa_ff_exact", "gaunt_cl", "gaunt_born", "sqrt3_over_pi",
    "saha", "neg_chi", "sigma_eh", "vmean_num", "inv_vmean_den", "c_cgs",
    "kb", "inv_mec2", "gr_pref", "sqrt_2pi")


class _FoldParams(ctypes.Structure):
    """Mirror of struct FoldParams in csrc/transfer_fold.cu."""
    _fields_ = ([(name, ctypes.c_int) for name in FOLD_INT_FIELDS]
                + [(name, ctypes.c_float) for name in FOLD_FLOAT_FIELDS])


MAX_VARS = 5


class _SphParams(ctypes.Structure):
    """Mirror of struct SphParams in csrc/resample_sph.cu: a scene of up to
    MAX_VARS variables and its distinct (phi, theta, r) axes."""
    _fields_ = ([("n", ctypes.c_longlong),
                 ("data", ctypes.c_void_p * MAX_VARS),
                 ("out", ctypes.c_void_p * MAX_VARS),
                 ("axis", (ctypes.c_void_p * MAX_VARS) * 3),
                 ("axis_len", (ctypes.c_int * MAX_VARS) * 3),
                 ("n_axes", ctypes.c_int * 3),
                 ("var_axis", (ctypes.c_int * 3) * MAX_VARS),
                 ("dims", (ctypes.c_int * 3) * MAX_VARS)]
                + [(name, ctypes.c_int) for name in (
                    "n_vars", "nx", "ny", "nz", "fill_on")]
                + [(name, ctypes.c_float) for name in (
                    "lon_offset", "r_min", "fill")])


class _ScanParams(ctypes.Structure):
    """Mirror of struct ScanParams in csrc/los_scans.cu."""
    _fields_ = [("n_rays", ctypes.c_longlong), ("n_rec", ctypes.c_int),
                ("scale", ctypes.c_float)]


class _DemParams(ctypes.Structure):
    """Mirror of struct DemParams in csrc/los_scans.cu."""
    _fields_ = [("nz", ctypes.c_int), ("nf", ctypes.c_int)]


def _harmonic_tables(s_max):
    """The folds' harmonic tables, (2, s_max + 1) float32: row 0 holds
    2 ln s and row 1 lgamma(s + 1) at column s (0 below s = 2), as the
    float32 per-harmonic tensors of physics.gyroresonance_kappa round them.
    An s_max below 1 gives the tables of s_max = 1, which sum no harmonic."""
    s = range(2, max(int(s_max), 1) + 1)
    log_s2 = [0.0, 0.0] + [2.0 * math.log(k) for k in s]
    lgam = [0.0, 0.0] + [math.lgamma(k + 1) for k in s]
    return np.asarray([log_s2, lgam], np.float32)


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "kernel library builds from csrc/ with it")
    return found


def build_library():
    """Compile csrc/*.cu with NVCC_FLAGS into _build/ unless a library of
    the same sources and flags is there already. Returns (path, ptxas
    log)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
    return lib, (log.read_text() if log.exists() else "")


@functools.cache
def library():
    """The kernel library, built if needed and loaded once per process."""
    return load_library(build_library()[0])


def load_library(path):
    """Load a library built by build_library and declare its C entries."""
    lib = ctypes.CDLL(str(path))
    ptr = ctypes.c_void_p
    # tcube, scube, state_in, state_out, records, params, stream
    lib.rgrff_trace_segment.argtypes = [ptr] * 5 + [_TraceParams, ptr]
    lib.rgrff_trace_segment.restype = ctypes.c_int
    # wpe, ne, te, b, bx, by, bz, tcube, scube, params, stream
    lib.rgrff_pack_trace_inputs.argtypes = [ptr] * 9 + [_PackParams, ptr]
    lib.rgrff_pack_trace_inputs.restype = ctypes.c_int
    # recs, freqs, tables, carry_in (4), prev_in, carry_out, prev_out,
    # params, stream
    lib.rgrff_fold_records.argtypes = [ptr] * 10 + [
        ctypes.POINTER(_FoldParams), ptr]
    lib.rgrff_fold_records.restype = ctypes.c_int
    # ds, te, ne, b, valid, sarea, theta, mech, freqs, tables, carry_in (4),
    # carry_out, params, stream
    lib.rgrff_fold_voxels.argtypes = [ptr] * 15 + [
        ctypes.POINTER(_FoldParams), ptr]
    lib.rgrff_fold_voxels.restype = ctypes.c_int
    # recs, prev_in, counts, params, stream
    lib.rgrff_fold_counts.argtypes = [ptr] * 3 + [
        ctypes.POINTER(_FoldParams), ptr]
    lib.rgrff_fold_counts.restype = ctypes.c_int
    # xs, ys, zs, params, stream
    lib.rgrff_resample_cube.argtypes = [ptr] * 3 + [
        ctypes.POINTER(_SphParams), ptr]
    # r_q, colat_q, phi_q, params, stream
    lib.rgrff_sample_sph.argtypes = [ptr] * 3 + [
        ctypes.POINTER(_SphParams), ptr]
    # pos, s, start, usable, valid, ds, params, stream
    lib.rgrff_valid_ds.argtypes = [ptr] * 6 + [
        ctypes.POINTER(_ScanParams), ptr]
    # tau, src, evan, m, out, params, stream
    lib.rgrff_dem_scan.argtypes = [ptr] * 5 + [
        ctypes.POINTER(_DemParams), ptr]
    for entry in ("rgrff_resample_cube", "rgrff_sample_sph",
                  "rgrff_valid_ds", "rgrff_dem_scan"):
        getattr(lib, entry).restype = ctypes.c_int
    lib.rgrff_error_string.argtypes = [ctypes.c_int]
    lib.rgrff_error_string.restype = ctypes.c_char_p
    return lib


def launch(entry, device, *args):
    """Call the C entry `entry` of library() with `args` and the current
    stream of the CUDA `device`; raise if it returns an error."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           + lib.rgrff_error_string(err).decode())
