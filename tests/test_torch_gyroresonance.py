"""The port's gyroresonance (mechanism bit 2) against the JAX package and
the independent SVD oracle of tests/test_gyroresonance.py: the exact
polarization coupling, its QL limit and X/O asymmetry, kappa_GR, and the
voxel update and batch transfer with bit 2."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu.grff import physics as jphys
from raytracinggrff_tpu.grff import transfer as jtr
from raytracinggrff_tpu_torch.grff import physics as pphys
from raytracinggrff_tpu_torch.grff import transfer as ptr

torch.set_num_threads(1)
AREA = (0.045 * 6.957e10) ** 2
F64 = torch.float64


def _svd_coupling(X, Y, theta, sigma):
    """F_sigma from the SVD null vector of the cold-plasma wave operator
    (B || z, k in the x-z plane), projected on the electron-sense rotation
    about B: the oracle of tests/test_gyroresonance.py."""
    n2 = jphys.refractive_index_sq(X, Y, theta, sigma, xp=np)
    s = 1 - X / (1 - Y * Y)
    d = -X * Y / (1 - Y * Y)
    p = 1 - X
    st, ct = np.sin(theta), np.cos(theta)
    m = np.array([[s - n2 * ct * ct, -1j * d, n2 * ct * st],
                  [1j * d, s - n2, 0.0],
                  [n2 * ct * st, 0.0, p - n2 * st * st]])
    _, _, vh = np.linalg.svd(m)
    e = vh[-1].conj()
    return float(abs(e[0] - 1j * e[1]) ** 2 / np.sum(abs(e) ** 2))


def _coupling(X, Y, theta, sigma):
    """The port's coupling in float64 at scalar arguments."""
    return float(pphys.gyro_polarization_coupling(
        torch.tensor(X, dtype=F64), torch.tensor(Y, dtype=F64),
        torch.tensor(theta, dtype=F64), sigma))


def _kappa(ne, te, b, nu, theta, sigma, dtype=F64):
    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype)
    return pphys.gyroresonance_kappa(t(ne), t(te), t(b), t(nu), t(theta),
                                     sigma).numpy()


@pytest.mark.parametrize("X", [1e-3, 0.02, 0.1])
def test_coupling_matches_svd_nullspace(X):
    """Tolerance of tests/test_gyroresonance.py: 1e-6 + 1e-4 relative."""
    for Y in (0.5, 1 / 3, 0.2):
        for deg in (0.5, 15, 45, 70, 80, 85, 89, 89.9, 90.0):
            th = np.deg2rad(deg)
            for sigma in (1.0, -1.0):
                got = _coupling(X, Y, th, sigma)
                ref = _svd_coupling(X, Y, th, sigma)
                assert abs(got - ref) <= 1e-6 + 1e-4 * abs(ref), (
                    X, Y, deg, sigma, got, ref)


def test_coupling_ql_limit_and_evenness():
    X, Y = 0.02, 1 / 3
    assert abs(_coupling(X, Y, 1e-4, -1.0) - 2.0) < 1e-3
    assert _coupling(X, Y, 1e-4, 1.0) < 1e-6
    for deg in (10, 25, 45):
        th = np.deg2rad(deg)
        for sigma in (1.0, -1.0):
            ql = (1 - sigma * abs(np.cos(th))) ** 2 / 2
            assert abs(_coupling(X, Y, th, sigma) - ql) < 0.04 + 0.03 * ql
    assert abs(_coupling(X, Y, np.deg2rad(60), -1.0)
               - _coupling(X, Y, np.deg2rad(120), -1.0)) < 1e-12


def test_perpendicular_xo_asymmetry():
    """X stays O(1) while O vanishes like cos^2 near 90 deg, and kappa_GR
    inherits the X/O ratio at the layer centre (rtol 1e-6 in float64)."""
    b, ne, te = 100.0, 1e9, 2e6
    nu = 3 * 2.7992e6 * b
    X = (8.93e3) ** 2 * ne / nu ** 2
    Y = 1 / 3
    for deg, min_ratio in ((80, 10.0), (85, 30.0), (89, 500.0)):
        th = np.deg2rad(deg)
        fx = _coupling(X, Y, th, -1.0)
        fo = _coupling(X, Y, th, 1.0)
        assert 0.9 < fx < 1.2 and fx / fo > min_ratio, (deg, fx, fo)
        kx = float(_kappa(ne, te, b, nu, th, -1.0))
        ko = float(_kappa(ne, te, b, nu, th, 1.0))
        np.testing.assert_allclose(kx / ko, fx / fo, rtol=1e-6)
    assert _coupling(X, Y, np.pi / 2, 1.0) == 0.0
    assert _coupling(X, Y, np.pi / 2, -1.0) > 0.5


def test_resonance_layers_and_float64_parity():
    """Opacity peaks at nu = s nu_B; in float64 the vectorised harmonic sum
    equals the JAX loop to rtol 1e-12 (summation order only)."""
    b = 100.0
    nu_b = 2.7992e6 * b
    ne, te, theta = 1e9, 2e6, np.deg2rad(45.0)
    for s in (2, 3):
        on = float(_kappa(ne, te, b, s * nu_b, theta, -1.0))
        off = float(_kappa(ne, te, b, (s + 0.5) * nu_b, theta, -1.0))
        assert on > 1e3 * max(off, 1e-30)
    nu = np.linspace(1.5, 5.5, 81) * nu_b
    for sigma in (1.0, -1.0):
        ref = jphys.gyroresonance_kappa(np.float64(ne), np.float64(te),
                                        np.float64(b), nu, theta, sigma,
                                        xp=np)
        np.testing.assert_allclose(_kappa(ne, te, b, nu, theta, sigma), ref,
                                   rtol=1e-12, atol=1e-300)


def test_kappa_float32_matches_jax():
    """float32 on random coronal and active-region voxels: rtol 1e-4 with
    atol 1e-24 cm^-1, below which a solar radius of path (7e10 cm) gives
    tau < 1e-13 (the JAX sum runs harmonic by harmonic, the port's over an
    s axis, and the 1e-38 floors are subnormal in float32)."""
    rng = np.random.default_rng(7)
    n = 3000
    ne = (10 ** rng.uniform(6, 10, n)).astype(np.float32)
    te = (10 ** rng.uniform(5.5, 6.8, n)).astype(np.float32)
    b = rng.uniform(5, 600, n).astype(np.float32)
    s_res = rng.uniform(1.8, 6.2, n).astype(np.float32)
    nu = (s_res * 2.7992e6 * b).astype(np.float32)
    th = rng.uniform(0.02, np.pi - 0.02, n).astype(np.float32)
    for sigma in (1.0, -1.0):
        for s_max in (4, 30):
            ref = np.asarray(jphys.gyroresonance_kappa(
                *(jnp.asarray(a) for a in (ne, te, b, nu, th)), sigma,
                s_max=s_max))
            got = pphys.gyroresonance_kappa(
                *(torch.as_tensor(a) for a in (ne, te, b, nu, th)), sigma,
                s_max=s_max).numpy()
            assert (ref > 1e-24).mean() > 0.25
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-24)


def _voxels(seed, nz=10, n_pix=48):
    """Active-region voxels around the third harmonic of 1 GHz, with
    invalid voxels, a NaN field and per-voxel theta and mechanism."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    v = dict(ne=10 ** rng.uniform(8, 10, (nz, n_pix)),
             te=10 ** rng.uniform(6, 6.6, (nz, n_pix)),
             b=rng.uniform(90, 140, (nz, n_pix)),
             ds=10 ** rng.uniform(7, 8.5, (nz, n_pix)),
             sarea=np.where(rng.random((nz, n_pix)) < 0.5,
                            rng.uniform(0.2, 3.0, (nz, n_pix)) * AREA, 0.0),
             theta=rng.uniform(0.1, np.pi - 0.1, (nz, n_pix)))
    v = {k: a.astype(f32) for k, a in v.items()}
    v["valid"] = rng.random((nz, n_pix)) > 0.15
    v["ne"][~v["valid"] & (rng.random((nz, n_pix)) < 0.5)] = np.nan
    v["mech"] = rng.choice(np.array([1, 3, 7, 2, 5], np.int32), (nz, n_pix))
    return v


def _run(update, init, v, lib, theta, mech):
    carry = init
    for i in range(v["ne"].shape[0]):
        args = [lib(v[k][i]) for k in ("ds", "te", "ne", "b", "valid",
                                       "sarea")]
        carry = update(carry, *args, lib(v["theta"][i]) if theta else None,
                       lib(v["mech"][i]) if mech else None)
    return [np.asarray(c) for c in carry]


@pytest.mark.parametrize("mechanism,theta,mech,s_max", [
    (7, False, False, 30), (3, True, False, 30), (7, True, True, 30),
    (2, False, False, 5)])
def test_voxel_update_with_gyroresonance_matches_jax(mechanism, theta, mech,
                                                     s_max):
    """The bar of tests/test_torch_transfer.py widened to rtol 2e-4 for
    the float32 harmonic sum; tau stays within rtol 2e-4 too."""
    v = _voxels(mechanism + 10 * theta + 20 * mech + s_max)
    freqs = jtr.log_spaced_freqs(1.0e9, 3, 0.05)
    n_pix = v["ne"].shape[1]
    ref = _run(jtr.make_voxel_update(freqs, AREA, 60.0, mechanism, s_max),
               jtr.transfer_carry_init(n_pix, 3), v, jnp.asarray, theta,
               mech)
    update = ptr.make_voxel_update(torch.as_tensor(freqs,
                                                   dtype=torch.float32),
                                   AREA, 60.0, mechanism, s_max)
    out = _run(update, ptr.transfer_carry_init(n_pix, 3, "cpu"), v,
               torch.as_tensor, theta, mech)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-30)
    assert (ref[3][np.isfinite(ref[3])] > 1.0).mean() > 0.2  # thick GR


def test_transfer_with_gr_flag():
    """As in tests/test_gyroresonance.py: bit 2 makes a thin free-free
    slab thick at the third harmonic, and the port's batch transfer
    equals JAX's (rtol 1e-4)."""
    nz, n_pix = 10, 1
    b = 100.0
    nu = np.array([3 * 2.7992e6 * b])
    arrays = dict(ds=np.full((nz, n_pix), 1e8), te=np.full((nz, n_pix), 2e6),
                  ne=np.full((nz, n_pix), 1e9), b=np.full((nz, n_pix), b),
                  valid=np.ones((nz, n_pix), bool))
    ff = ptr.grff_transfer(**arrays, freqs_hz=nu, pixel_area_cm2=AREA,
                           theta_deg=45.0, mechanism=1, device="cpu")
    gr = ptr.grff_transfer(**arrays, freqs_hz=nu, pixel_area_cm2=AREA,
                           theta_deg=45.0, mechanism=1 + 2 + 4,
                           device="cpu")
    assert float(gr.tau_x[0, 0]) > 10 * float(ff.tau_x[0, 0])
    assert float(gr.flux_x[0, 0]) > float(ff.flux_x[0, 0])
    ref = jtr.grff_transfer(**arrays, freqs_hz=nu, pixel_area_cm2=AREA,
                            theta_deg=45.0, mechanism=1 + 2 + 4)
    for name in ("flux_o", "flux_x", "tau_o", "tau_x"):
        np.testing.assert_allclose(getattr(gr, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-4)
