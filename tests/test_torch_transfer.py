"""The port's free-free physics and per-voxel transfer update against the
JAX package (float32) and the float64 NumPy reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu.grff import physics as jphys
from raytracinggrff_tpu.grff import transfer as jtr
from raytracinggrff_tpu.grff.reference import grff_transfer_reference
from raytracinggrff_tpu_torch.grff import physics as pphys
from raytracinggrff_tpu_torch.grff import transfer as ptr

torch.set_num_threads(1)
AREA = (0.045 * 6.957e10) ** 2


def _voxels(seed, nz=12, n_pix=64):
    """Random per-voxel fields, step-major (nz, n_pix) float32, with
    overdense (evanescent) voxels at the low end of the frequencies,
    invalid voxels and a NaN field in an invalid voxel."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    v = dict(ne=10 ** rng.uniform(5, 8.2, (nz, n_pix)),
             te=10 ** rng.uniform(4, 6.5, (nz, n_pix)),
             b=rng.uniform(0, 20, (nz, n_pix)),
             ds=10 ** rng.uniform(8, 10.5, (nz, n_pix)),
             sarea=np.where(rng.random((nz, n_pix)) < 0.5,
                            rng.uniform(0.2, 3.0, (nz, n_pix)) * AREA, 0.0),
             theta=rng.uniform(0.05, np.pi - 0.05, (nz, n_pix)))
    v = {k: a.astype(f32) for k, a in v.items()}
    v["valid"] = rng.random((nz, n_pix)) > 0.15
    v["ne"][~v["valid"] & (rng.random((nz, n_pix)) < 0.5)] = np.nan
    v["theta"][0, :4] = np.float32(np.pi / 2)    # perpendicular dead zone
    v["mech"] = rng.choice(np.array([1, 5, 4, 0], np.int32), (nz, n_pix))
    return v


def _run(update, init, v, lib, theta=False, mech=False):
    carry = init
    for i in range(v["ne"].shape[0]):
        args = [lib(v[k][i]) for k in ("ds", "te", "ne", "b", "valid",
                                       "sarea")]
        carry = update(carry, *args, lib(v["theta"][i]) if theta else None,
                       lib(v["mech"][i]) if mech else None)
    return [np.asarray(c) for c in carry]


@pytest.mark.parametrize("mechanism,gaunt,theta,mech", [
    (1, "dulk", False, False), (5, "dulk", False, False),
    (5, "exact", False, False), (5, "dulk", True, False),
    (5, "exact", True, True), (1, "dulk", False, True)])
def test_voxel_update_matches_jax(mechanism, gaunt, theta, mech):
    v = _voxels(mechanism + 10 * theta + 20 * mech)
    freqs = jtr.log_spaced_freqs(75e6, 3, 0.05)
    n_pix = v["ne"].shape[1]
    ref = _run(jtr.make_voxel_update(freqs, AREA, 70.0, mechanism,
                                     gaunt=gaunt),
               jtr.transfer_carry_init(n_pix, 3), v, jnp.asarray, theta,
               mech)
    ft = torch.as_tensor(freqs, dtype=torch.float32)
    out = _run(ptr.make_voxel_update(ft, AREA, 70.0, mechanism,
                                     gaunt=gaunt),
               ptr.transfer_carry_init(n_pix, 3, "cpu"), v,
               torch.as_tensor, theta, mech)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-30)
    assert np.isinf(ref[2]).any()          # some evanescent voxels
    assert (ref[0] > 0).mean() > 0.3


def test_handedness_swap_exchanges_slots():
    v = _voxels(3, nz=4, n_pix=8)
    ft = torch.as_tensor(jtr.log_spaced_freqs(75e6, 2, 0.1),
                         dtype=torch.float32)
    update = ptr.make_voxel_update(ft, AREA, 90.0, 5)
    init = ptr.transfer_carry_init(8, 2, "cpu")
    v["b"][:] = 5.0
    v["valid"][:] = True
    v["ne"] = np.nan_to_num(v["ne"], nan=1e6)
    v["theta"][:] = np.float32(0.3)
    fwd = _run(update, init, v, torch.as_tensor, theta=True)
    v["theta"][:] = np.float32(np.pi - 0.3)
    back = _run(update, init, v, torch.as_tensor, theta=True)
    np.testing.assert_allclose(back[0], fwd[1], rtol=1e-5)
    np.testing.assert_allclose(back[1], fwd[0], rtol=1e-5)
    assert not np.allclose(fwd[0], fwd[1])


def test_physics_functions_match_jax():
    rng = np.random.default_rng(5)
    n = 2000
    ne = (10 ** rng.uniform(4, 10, n)).astype(np.float32)
    te = (10 ** rng.uniform(3.7, 7, n)).astype(np.float32)
    b = rng.uniform(0, 100, n).astype(np.float32)
    nu = (10 ** rng.uniform(7.5, 9.5, n)).astype(np.float32)
    th = rng.uniform(0, np.pi, n).astype(np.float32)
    J = [jnp.asarray(a) for a in (ne, te, b, nu, th)]
    P = [torch.as_tensor(a) for a in (ne, te, b, nu, th)]

    def close(p, j, rtol=2e-5):
        # atol: opacities below 1e-30 cm^-1 sit in the denormal range,
        # where one library flushes to zero and the other does not
        np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=rtol,
                                   atol=1e-30)

    close(pphys.coulomb_log(P[1], P[3]), jphys.coulomb_log(J[1], J[3]))
    close(pphys.exact_gaunt(P[1], P[3]), jphys.exact_gaunt(J[1], J[3]))
    close(pphys.saha_neutral_hydrogen(P[0], P[1]),
          jphys.saha_neutral_hydrogen(J[0], J[1]), rtol=1e-4)
    X, Y = P[0] * 8.93e3 ** 2 / P[3] ** 2, P[2] * 2.7992e6 / P[3]
    for sigma in (1.0, -1.0):
        close(pphys.refractive_index_sq(X, Y, P[4], sigma),
              jphys.refractive_index_sq(jnp.asarray(X.numpy()),
                                        jnp.asarray(Y.numpy()), J[4], sigma),
              rtol=1e-4)
        close(pphys.neutral_hydrogen_kappa(*P, sigma),
              jphys.neutral_hydrogen_kappa(*J, sigma), rtol=1e-4)
        for gaunt in ("dulk", "exact"):
            kp, n2p = pphys.freefree_kappa(*P, sigma, gaunt=gaunt)
            kj, n2j = jphys.freefree_kappa(*J, sigma, gaunt=gaunt)
            close(n2p, n2j, rtol=1e-4)
            close(kp, kj, rtol=1e-4)
    for name in ("KAPPA_FF_COEF", "KAPPA_FF_EXACT_COEF", "GAUNT_CL_CONST",
                 "GAUNT_BORN_CONST", "SQRT3_OVER_PI", "SAHA_COEF",
                 "CHI_H_OVER_K", "SIGMA_EH_CM2", "O_MODE", "X_MODE"):
        assert getattr(pphys, name) == pytest.approx(getattr(jphys, name),
                                                     rel=1e-14)


def test_tb_from_sfu_and_freqs_match_jax():
    freqs = ptr.log_spaced_freqs(75e6, 4, 0.05)
    np.testing.assert_array_equal(freqs, jtr.log_spaced_freqs(75e6, 4, 0.05))
    flux = np.random.default_rng(0).uniform(0, 10, (9, 4)).astype(np.float32)
    ref = jtr.tb_from_sfu(jnp.asarray(flux), jnp.asarray(freqs, jnp.float32),
                          AREA)
    out = ptr.tb_from_sfu(torch.as_tensor(flux),
                          torch.as_tensor(freqs, dtype=torch.float32), AREA)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("mechanism", [1, 5])
def test_los_matches_float64_reference(mechanism):
    """A smooth coronal LOS (voxel 0 the far end) through the port's f32
    update agrees with grff/reference.py in float64 within 1%."""
    nz, n_pix = 60, 4
    s = np.linspace(0.0, 1.0, nz)[:, None] * np.ones((1, n_pix))
    ne = 2e8 * np.exp(-3 * (1 - s)) * np.array([1.0, 0.7, 0.4, 0.1])
    te = 1.5e6 * (0.6 + 0.4 * s)
    b = 2.0 + 3.0 * s
    ds = np.full((nz, n_pix), 3e8)
    valid = np.ones((nz, n_pix), bool)
    theta = np.full((nz, n_pix), 50.0)
    freqs = ptr.log_spaced_freqs(150e6, 3, 0.1)
    ref = grff_transfer_reference(ds, te, ne, b, valid, freqs, AREA,
                                  theta_deg=theta, mechanism=mechanism)
    update = ptr.make_voxel_update(torch.as_tensor(freqs,
                                                   dtype=torch.float32),
                                   AREA, 50.0, mechanism)
    carry = ptr.transfer_carry_init(n_pix, 3, "cpu")
    f32 = torch.float32
    for k in range(nz):
        carry = update(carry, *(torch.as_tensor(a[k], dtype=f32)
                                for a in (ds, te, ne, b)),
                       torch.as_tensor(valid[k]), torch.zeros(n_pix))
    np.testing.assert_allclose(carry[0].numpy(), ref["flux_o"], rtol=1e-2)
    np.testing.assert_allclose(carry[1].numpy(), ref["flux_x"], rtol=1e-2)
    assert ref["flux_o"].min() > 0
