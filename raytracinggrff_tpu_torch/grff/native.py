"""ctypes loader for the native GRFF transfer library
(raytracinggrff_tpu/grff/native.py).

Builds native/grff_transfer.cpp with g++ into the port's git-ignored
_build/ directory (never into native/) and loads it. The binding mirrors
the reference's initGET_MW (script/synthetic_FF_map_single_thread.py:
27-35), so it can cross-check grff/transfer.get_mw on the host.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
from numpy.ctypeslib import ndpointer

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / \
    "grff_transfer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "GRFF_DEM_Transfer.so"


def build_native_lib(build_dir=BUILD_DIR, force=False) -> Path:
    """Compile native/grff_transfer.cpp with g++ into build_dir unless a
    library newer than the source is there; returns its path."""
    build_dir = Path(build_dir)
    lib = build_dir / LIB_NAME
    if lib.exists() and not force \
            and lib.stat().st_mtime >= NATIVE_SRC.stat().st_mtime:
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, str(NATIVE_SRC)], check=True)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def init_get_mw(libname=None):
    """Reference-identical ctypes binding (initGET_MW contract)."""
    _intp = ndpointer(dtype=ctypes.c_int32, flags="F")
    _doublep = ndpointer(dtype=ctypes.c_double, flags="F")
    lib = ctypes.CDLL(str(libname or build_native_lib()))
    fn = lib.PyGET_MW
    fn.argtypes = [_intp, _doublep, _doublep, _doublep, _doublep,
                   _doublep, _doublep]
    fn.restype = ctypes.c_int
    return fn


def get_mw_native(lparms, rparms, parms, t=None, dem=None, ddm=None,
                  fn=None):
    """Call the native library with the GET_MW contract; returns RL (7, Nf).

    Same signature as grff.transfer.get_mw for cross-validation; `fn` is
    a binding from init_get_mw (default: the library in _build/). DEM
    mode: set Lparms[2] = NT and pass t (NT,) ascending K grid and dem
    (NT, Nz) column-major [cm^-5 K^-1] (see native/grff_transfer.cpp).
    DDM-mode inputs (Lparms[4] != 0) return status 2 and raise — not
    implemented. The reference's dummy scalars select the uniform-T
    path."""
    fn = fn or init_get_mw()
    lparms = np.asarray(lparms, np.int32)
    if lparms.size < 5:   # C side reads Lparms[0..4] (reference layout)
        lparms = np.concatenate([lparms, np.zeros(5 - lparms.size,
                                                  np.int32)])
    lparms = np.asfortranarray(lparms)
    rparms = np.asfortranarray(np.asarray(rparms, np.float64))
    parms = np.asfortranarray(np.asarray(parms, np.float64))
    nf = int(lparms[1])
    rl = np.zeros((7, nf), np.float64, order="F")

    def farr(x):
        return np.asfortranarray(
            np.atleast_1d(np.asarray(0.0 if x is None else x, np.float64)))
    t_a, dem_a, ddm_a = farr(t), farr(dem), farr(ddm)
    nt = int(lparms[2]) if lparms.size > 2 else 0
    if nt > 0:
        # the C side cannot know array lengths; guard the ABI here
        nz = int(lparms[0])
        if t_a.size != nt or dem_a.size != nt * nz:
            raise ValueError(
                f"DEM mode (Lparms[2]={nt}) needs T with {nt} entries and "
                f"DEM with NT*Nz={nt * nz} (column-major), got "
                f"{t_a.size}/{dem_a.size}")
    res = fn(lparms, rparms, parms, t_a, dem_a, ddm_a, rl)
    if res == 2:
        raise NotImplementedError(
            "PyGET_MW status 2: DDM transfer mode (Lparms[4] != 0) is "
            "not implemented")
    if res != 0:
        raise RuntimeError(f"PyGET_MW returned status {res}")
    return rl
