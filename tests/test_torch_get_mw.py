"""The port's GET_MW surface (get_mw, get_mw_slice, the DEM mode) against
the JAX package and the native C++ library of native/grff_transfer.cpp,
on the cases of tests/test_native_grff.py and at its tolerances. The
port's grff/native.py compiles the native library into a temporary
directory for this module."""

import shutil

import numpy as np
import pytest
import torch

from raytracinggrff_tpu.constants import (AU_CM, C_CGS, FB_COEF, FPE_COEF,
                                          KB_CGS, SFU2CGS)
from raytracinggrff_tpu.grff import transfer as jtr
from raytracinggrff_tpu.grff.physics import (KAPPA_FF_COEF, coulomb_log,
                                             refractive_index_sq)
from raytracinggrff_tpu_torch.grff import native as pnative
from raytracinggrff_tpu_torch.grff import transfer as ptr

torch.set_num_threads(1)
AREA = (0.045 * 6.957e10) ** 2


def port_get_mw(*args, **kw):
    return ptr.get_mw(*args, device="cpu", **kw)


@pytest.fixture(scope="module")
def native_get_mw(tmp_path_factory):
    """get_mw through the native library's PyGET_MW ABI: the port's
    grff/native.get_mw_native on a library built into a temporary
    directory."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    fn = pnative.init_get_mw(pnative.build_native_lib(
        tmp_path_factory.mktemp("native")))

    def call(lparms, rparms, parms, t=None, dem=None):
        return pnative.get_mw_native(lparms, rparms, parms, t=t, dem=dem,
                                     fn=fn)
    return call


def _pack(ds, te, ne, b, s_area=None, theta=90.0, mech=5):
    nz = len(ds)
    parms = np.zeros((15, nz), order="F")
    parms[0], parms[1], parms[2], parms[3] = ds, te, ne, b
    parms[4] = theta
    parms[6] = mech
    parms[7] = 30
    if s_area is not None:
        parms[14] = s_area
    return parms


def _close(a, b, rtol, rows=(1, 2, 5, 6)):
    for row in rows:
        np.testing.assert_allclose(a[row], b[row], rtol=rtol,
                                   err_msg=f"RL[{row}]")


def test_uniform_matches_jax_and_native(native_get_mw):
    """Random LOS with per-voxel source areas: the port equals JAX to rtol
    1e-5 (both float32) and the native float64 library to 2e-3."""
    rng = np.random.default_rng(0)
    nz, nf = 60, 4
    parms = _pack(rng.uniform(5e8, 5e9, nz), 10 ** rng.uniform(4.2, 6.5, nz),
                  10 ** rng.uniform(6.0, 9.0, nz), rng.uniform(0.0, 5.0, nz),
                  np.where(rng.uniform(size=nz) > 0.5,
                           AREA * rng.uniform(0.5, 2.0, nz), 0.0))
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 400e6, 0.15])
    rl = port_get_mw(lparms, rparms, parms)
    _close(rl, jtr.get_mw(lparms, rparms, parms), 1e-5)
    np.testing.assert_allclose(rl[0], jtr.get_mw(lparms, rparms, parms)[0])
    _close(rl, native_get_mw(lparms, rparms, parms), 2e-3, rows=(5, 6))


def test_gyroresonance_matches_native(native_get_mw):
    """Mechanism 1+2+4 at 200 G around the 3rd-5th harmonics (rtol 2e-2
    against the native library, 1e-4 against JAX); bit 2 changes the
    answer."""
    nz, nf = 5, 3
    parms = _pack(np.full(nz, 1e8), np.full(nz, 2e6), np.full(nz, 1e9),
                  np.full(nz, 200.0), theta=60.0, mech=1 + 2 + 4)
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([1e18, 1.0e9, 0.05])
    rl = port_get_mw(lparms, rparms, parms)
    _close(rl, native_get_mw(lparms, rparms, parms), 2e-2, rows=(5, 6))
    _close(rl, jtr.get_mw(lparms, rparms, parms), 1e-4)
    parms[6] = 1 + 4
    assert np.max(np.abs(rl[5] - port_get_mw(lparms, rparms, parms)[5])) > 0


def test_per_voxel_theta():
    """Parms[4] varying along the LOS changes the answer, matches JAX
    (rtol 1e-5), and a uniform column equals the scalar path (1e-6)."""
    nz, nf = 12, 2
    parms = _pack(np.full(nz, 2e9), np.full(nz, 1.2e6), np.full(nz, 4e8),
                  np.full(nz, 3.0), theta=90.0, mech=1 + 4)
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 200e6, 0.1])
    rl_uniform = port_get_mw(lparms, rparms, parms)
    parms_var = parms.copy()
    parms_var[4] = np.linspace(20.0, 90.0, nz)
    rl_var = port_get_mw(lparms, rparms, parms_var)
    assert np.max(np.abs(rl_var[5] - rl_uniform[5])) > 0
    _close(rl_var, jtr.get_mw(lparms, rparms, parms_var), 1e-5)
    parms_same = parms.copy()
    parms_same[4, :] = 47.5
    parms_same[4, 0] = 47.5 + 1e-12     # forces the per-voxel path
    rl_a = port_get_mw(lparms, rparms, parms_same)
    parms_scalar = parms.copy()
    parms_scalar[4] = 47.5
    rl_b = port_get_mw(lparms, rparms, parms_scalar)
    np.testing.assert_allclose(rl_a[5], rl_b[5], rtol=1e-6)


def test_per_voxel_mechanism_mixed_los(native_get_mw):
    """A chromosphere+corona LOS with per-voxel Parms[6] against JAX (rtol
    1e-5) and the native library (2e-3); the neutral bit adds depth; a
    uniform per-voxel mech array equals the scalar path; per-voxel bit 2
    against the native library (2e-2)."""
    nz, nf = 24, 3
    te = np.concatenate([np.full(8, 8e3), np.full(16, 1.4e6)])
    ne = np.concatenate([np.full(8, 2e10), np.full(16, 4e8)])
    parms = _pack(np.full(nz, 5e7), te, ne, np.full(nz, 3.0), theta=75.0,
                  mech=5)
    parms[6, :8] = 1 + 4
    parms[6, 8:] = 1
    lparms = np.array([nz, nf, 0, 0, 0], np.int32)
    rparms = np.array([AREA, 200e6, 0.1])
    rl = port_get_mw(lparms, rparms, parms)
    _close(rl, jtr.get_mw(lparms, rparms, parms), 1e-5)
    _close(rl, native_get_mw(lparms, rparms, parms), 2e-3, rows=(5, 6))
    # above the chromosphere's plasma frequency the neutral bit adds depth
    parms_all = parms.copy()
    parms_all[6, :] = 1
    rp_hi = np.array([AREA, 3e9, 0.1])
    assert np.all(port_get_mw(lparms, rp_hi, parms)[1]
                  > port_get_mw(lparms, rp_hi, parms_all)[1])

    freqs = 200e6 * 10 ** (0.1 * np.arange(nf))
    common = dict(ds=parms[0, :, None], te=parms[1, :, None],
                  ne=parms[2, :, None], b=parms[3, :, None],
                  valid=np.ones((nz, 1), bool), freqs_hz=freqs,
                  pixel_area_cm2=AREA, theta_deg=75.0, device="cpu")
    res_scalar = ptr.grff_transfer(mechanism=5, **common)
    res_arr = ptr.grff_transfer(mechanism=np.full(nz, 5, np.int32), **common)
    np.testing.assert_allclose(res_arr.flux_o.numpy(),
                               res_scalar.flux_o.numpy(), rtol=1e-6)
    np.testing.assert_allclose(res_arr.flux_x.numpy(),
                               res_scalar.flux_x.numpy(), rtol=1e-6)

    parms_gr = _pack(np.full(nz, 1e8), np.full(nz, 2e6), np.full(nz, 1e9),
                     np.full(nz, 200.0), theta=60.0, mech=1 + 4)
    parms_gr[6, 10:14] = 1 + 2 + 4
    rp_gr = np.array([1e18, 1.0e9, 0.05])
    rl_gr = port_get_mw(lparms, rp_gr, parms_gr)
    _close(rl_gr, native_get_mw(lparms, rp_gr, parms_gr), 2e-2, rows=(5, 6))
    _close(rl_gr, jtr.get_mw(lparms, rp_gr, parms_gr), 1e-4)


def test_ddm_rejected_and_dem_validated():
    """The same errors as the JAX package: DDM raises NotImplementedError,
    half-dummy T/DEM input is a ValueError, and the dummy scalars select
    the uniform-T path."""
    nz, nf = 6, 2
    parms = _pack(np.full(nz, 1e9), np.full(nz, 1e6), np.full(nz, 1e8),
                  np.full(nz, 1.0))
    rparms = np.array([AREA, 100e6, 0.1])
    lp_ok = np.array([nz, nf, 0, 0, 0], np.int32)
    with pytest.raises(NotImplementedError, match="DDM"):
        port_get_mw(np.array([nz, nf, 0, 0, 1], np.int32), rparms, parms)
    with pytest.raises(NotImplementedError, match="DDM"):
        port_get_mw(lp_ok, rparms, parms, ddm=np.ones(4))
    with pytest.raises(ValueError, match="Lparms"):
        port_get_mw(lp_ok, rparms, parms, t=np.array(1e6))
    lp_dem = np.array([nz, nf, 5, 1, 0], np.int32)
    with pytest.raises(ValueError, match="dummy"):
        port_get_mw(lp_dem, rparms, parms)
    with pytest.raises(ValueError, match="NT >= 2"):
        port_get_mw(np.array([nz, nf, 1, 1, 0], np.int32), rparms, parms,
                    t=np.array([1e6]), dem=np.ones(nz))
    with pytest.raises(ValueError, match="ascending"):
        port_get_mw(np.array([nz, nf, 2, 1, 0], np.int32), rparms, parms,
                    t=np.array([2e6, 1e6]), dem=np.ones(2 * nz))
    with pytest.raises(ValueError, match="NT\\*Nz"):
        port_get_mw(np.array([nz, nf, 2, 1, 0], np.int32), rparms, parms,
                    t=np.array([1e6, 2e6]), dem=np.ones(2 * nz + 1))
    rl = port_get_mw(lp_ok, rparms, parms, t=np.array(0.0),
                     dem=np.array(0.0), ddm=np.array(0.0))
    assert np.all(rl[5] > 0)
    _close(rl, jtr.get_mw(lp_ok, rparms, parms), 1e-5)


def _dem_case(nz=20, nt=40, nf=3):
    """Mixed LOS with a broad log-normal DEM per voxel (the case of
    tests/test_native_grff.py)."""
    rng = np.random.default_rng(5)
    t_grid = np.logspace(4.5, 6.8, nt)
    t_peak = 10 ** rng.uniform(5.2, 6.4, nz)
    em = 10 ** rng.uniform(24.0, 26.0, nz)
    prof = np.exp(-0.5 * (np.log(t_grid[:, None] / t_peak[None, :])
                          / 0.5) ** 2)
    w = np.gradient(t_grid)
    dem = em[None, :] * prof / np.sum(w[:, None] * prof, axis=0)
    ds = rng.uniform(5e8, 5e9, nz)
    te = np.sum(w[:, None] * dem * t_grid[:, None], axis=0) / em
    parms = _pack(ds, te, np.sqrt(em / ds), rng.uniform(0.5, 4.0, nz),
                  theta=70.0, mech=1)
    lparms = np.array([nz, nf, nt, 1, 0], np.int32)
    rparms = np.array([AREA, 150e6, 0.2])
    return t_grid, dem, parms, lparms, rparms


def test_dem_matches_float64_quadrature_oracle():
    """DEM mode against an independent float64 trapezoid quadrature of
    the kernel moments and the scalar recursion (rtol 2e-3), and against
    JAX (rtol 1e-5). The DEM goes in column-major, as the ABI has it."""
    t_grid, dem, parms, lparms, rparms = _dem_case()
    nz, nf = int(lparms[0]), int(lparms[1])
    freqs = rparms[1] * 10 ** (rparms[2] * np.arange(nf))
    dem_f = np.asfortranarray(dem).ravel(order="F")
    rl = port_get_mw(lparms, rparms, parms, t=t_grid, dem=dem_f)
    _close(rl, jtr.get_mw(lparms, rparms, parms, t=t_grid, dem=dem), 1e-5)
    w = np.concatenate([[t_grid[1] - t_grid[0]], t_grid[2:] - t_grid[:-2],
                        [t_grid[-1] - t_grid[-2]]]) / 2.0
    theta = np.deg2rad(70.0)
    lnlam = coulomb_log(t_grid[:, None], freqs[None, :], xp=np)
    for m_i, sigma in ((5, 1.0), (6, -1.0)):
        flux = np.zeros(nf)
        for k in range(nz):
            m_k = np.sum((w * dem[:, k] * t_grid ** -1.5)[:, None] * lnlam,
                         axis=0)
            m_j = np.sum((w * dem[:, k] * t_grid ** -0.5)[:, None] * lnlam,
                         axis=0)
            X = FPE_COEF ** 2 * parms[2, k] / freqs ** 2
            Y = FB_COEF * parms[3, k] / freqs
            n2 = refractive_index_sq(X, Y, theta, sigma, xp=np)
            eff2 = (freqs + sigma * FB_COEF * parms[3, k]
                    * abs(np.cos(theta))) ** 2
            tau = KAPPA_FF_COEF * m_k / (np.sqrt(np.maximum(n2, 1e-12))
                                         * eff2)
            src = (KB_CGS * (m_j / m_k) * freqs ** 2 / C_CGS ** 2 / SFU2CGS
                   * AREA / AU_CM ** 2)
            flux = flux * np.exp(-tau) + src * -np.expm1(-tau)
            flux = np.where(n2 <= 0, 0.0, flux)
        np.testing.assert_allclose(rl[m_i], flux, rtol=2e-3,
                                   err_msg=f"mode RL[{m_i}]")
    assert np.all(rl[5] > 0)


def test_dem_delta_function_reduces_to_uniform_t(native_get_mw):
    """A DEM concentrated at T0 with EM = ne^2 ds per voxel reproduces the
    uniform-T free-free path (rtol 2e-3), and the native library's DEM
    mode (2e-3)."""
    nz, nf, nt = 10, 2, 201
    t0 = 1.2e6
    ds = np.full(nz, 2e9)
    ne = np.full(nz, 3e8)
    parms = _pack(ds, np.full(nz, t0), ne, np.full(nz, 2.0), theta=80.0,
                  mech=1)
    rparms = np.array([AREA, 120e6, 0.15])
    rl_uni = port_get_mw(np.array([nz, nf, 0, 0, 0], np.int32), rparms,
                         parms)
    t_grid = np.linspace(t0 * 0.97, t0 * 1.03, nt)
    prof = np.exp(-0.5 * ((t_grid - t0) / (t0 * 0.004)) ** 2)
    w = np.gradient(t_grid)
    dem = (np.tile((prof / np.sum(w * prof))[:, None], (1, nz))
           * (ne ** 2 * ds)[None, :])
    lp_dem = np.array([nz, nf, nt, 1, 0], np.int32)
    rl_dem = port_get_mw(lp_dem, rparms, parms, t=t_grid, dem=dem)
    _close(rl_dem, rl_uni, 2e-3, rows=(5, 6))
    rl_native = native_get_mw(lp_dem, rparms, parms, t=t_grid,
                              dem=np.asfortranarray(dem))
    _close(rl_dem, rl_native, 2e-3, rows=(5, 6))


def test_dem_mixed_mechanism_matches_native_and_jax(native_get_mw):
    """DEM free-free with per-voxel gyro and neutral bits: the native
    library at rtol 2e-2, JAX at 1e-4."""
    t_grid, dem, parms, lparms, rparms = _dem_case(nz=16, nt=30, nf=2)
    parms[6, :8] = 1 + 4
    parms[6, 8:12] = 1 + 2
    parms[3, 8:12] = 150.0
    rl = port_get_mw(lparms, rparms, parms, t=t_grid, dem=dem)
    _close(rl, native_get_mw(lparms, rparms, parms, t=t_grid,
                             dem=np.asfortranarray(dem)), 2e-2, rows=(5, 6))
    _close(rl, jtr.get_mw(lparms, rparms, parms, t=t_grid, dem=dem), 1e-4)
    assert np.all(rl[5] > 0)


@pytest.mark.parametrize("theta,mechanism", [
    (70.0, 5), ("per_voxel", 5), ("per_pixel", 5), (70.0, "per_voxel"),
    (35.0, 7)])
def test_get_mw_slice_matches_jax(theta, mechanism):
    """The batched all-pixels entry with scalar, (Nz,) and (Nz, n_pix)
    theta and per-voxel mechanism flags: rtol 1e-5 (1e-4 with bit 2)."""
    rng = np.random.default_rng(11)
    nz, n_pix = 16, 24
    ds = rng.uniform(1e8, 3e9, (nz, n_pix))
    te = 10 ** rng.uniform(4.0, 6.5, (nz, n_pix))
    ne = 10 ** rng.uniform(7.0, 9.5, (nz, n_pix))
    b = rng.uniform(0.0, 150.0, (nz, n_pix))
    valid = rng.random((nz, n_pix)) > 0.1
    sarea = rng.uniform(0.5, 2.0, (nz, n_pix)) * AREA
    if theta == "per_voxel":
        theta = np.linspace(10.0, 170.0, nz)
    elif theta == "per_pixel":
        theta = rng.uniform(5.0, 175.0, (nz, n_pix))
    if mechanism == "per_voxel":
        mechanism = rng.choice(np.array([1, 5, 4], np.int32), nz)
    args = (ds, te, ne, b, valid, 1e9, 3, 0.1, AREA)
    kw = dict(s_area_cm2=sarea, theta_deg=theta, mechanism=mechanism)
    ref = jtr.get_mw_slice(*args, **kw)
    got = ptr.get_mw_slice(*args, device="cpu", **kw)
    rtol = 1e-4 if np.ndim(mechanism) == 0 and mechanism & 2 else 1e-5
    for name in ("flux_o", "flux_x", "tau_o", "tau_x"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=1e-30, err_msg=name)
    np.testing.assert_allclose(got.freqs_ghz.numpy(),
                               np.asarray(ref.freqs_ghz), rtol=2e-7)
