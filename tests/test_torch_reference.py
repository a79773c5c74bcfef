"""The port's float64 GRFF reference (grff/reference.py) against the JAX
package's on the inputs of tests/test_grff.py and tests/test_gyroresonance.py
(mechanisms 1/5/7, scalar and per-voxel theta, both Gaunt options) to rtol
1e-9, and the port's float32 grff_transfer against it within 1% in T_b,
the bar of PERF.md section 1."""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu.grff.reference import (
    grff_transfer_reference as jax_reference)
from raytracinggrff_tpu_torch.grff.reference import grff_transfer_reference
from raytracinggrff_tpu_torch.grff.transfer import (grff_transfer,
                                                    log_spaced_freqs,
                                                    tb_from_sfu)

torch.set_num_threads(1)
AREA = (0.045 * 6.957e10) ** 2      # tests/test_grff.py:21


def _scene(name):
    """(ds, te, ne, b, valid, freqs, s_area, per-voxel theta) of a scene of
    the JAX tests."""
    if name == "parity":            # tests/test_grff.py:96-119
        rng = np.random.default_rng(7)
        nz, n_pix = 80, 16
        ds = rng.uniform(5e8, 5e9, (nz, n_pix))
        te = 10 ** rng.uniform(4.2, 6.5, (nz, n_pix))
        ne = 10 ** rng.uniform(6.0, 9.0, (nz, n_pix))
        b = rng.uniform(0.0, 5.0, (nz, n_pix))
        valid = rng.uniform(size=(nz, n_pix)) > 0.2
        s_area = np.where(rng.uniform(size=(nz, n_pix)) > 0.5,
                          AREA * rng.uniform(0.5, 2.0, (nz, n_pix)), 0.0)
        freqs = log_spaced_freqs(400e6, 4, 0.15)
    elif name == "gr_layers":       # tests/test_grff.py:181-218
        rng = np.random.default_rng(7)
        nz, n_pix = 40, 8
        ds = rng.uniform(1e8, 1e9, (nz, n_pix))
        te = 10 ** rng.uniform(5.8, 6.6, (nz, n_pix))
        ne = 10 ** rng.uniform(7.5, 9.0, (nz, n_pix))
        b = rng.uniform(60.0, 220.0, (nz, n_pix))
        valid = rng.uniform(size=(nz, n_pix)) > 0.15
        s_area = None
        freqs = log_spaced_freqs(1.0e9, 3, 0.05)
    else:                           # tests/test_gyroresonance.py:227-243
        rng = np.random.default_rng(5)
        nz, n_pix = 10, 3
        ds = np.full((nz, n_pix), 1e8)
        te = np.full((nz, n_pix), 2e6)
        ne = np.full((nz, n_pix), 1e9)
        b = np.full((nz, n_pix), 100.0)
        valid = np.ones((nz, n_pix), bool)
        s_area = None
        freqs = np.array([3 * 2.7992e6 * 100.0])
    theta = rng.uniform(20.0, 160.0, ds.shape)
    return ds, te, ne, b, valid, freqs, s_area, theta


def _both(scene, mechanism, theta_kind, gaunt):
    ds, te, ne, b, valid, freqs, s_area, theta = _scene(scene)
    theta_deg = {"scalar": 45.0, "per_voxel": theta,
                 "per_step": theta[:, 0]}[theta_kind]
    kw = dict(s_area_cm2=s_area, theta_deg=theta_deg, mechanism=mechanism,
              gaunt=gaunt)
    args = (ds, te, ne, b, valid, freqs, AREA)
    return args, kw, grff_transfer_reference(*args, **kw), \
        jax_reference(*args, **kw)


@pytest.mark.parametrize("gaunt", ["dulk", "exact"])
@pytest.mark.parametrize("theta_kind", ["scalar", "per_voxel", "per_step"])
@pytest.mark.parametrize("mechanism", [1, 5, 7])
@pytest.mark.parametrize("scene", ["parity", "gr_layers", "gr_slab"])
def test_reference_matches_jax_reference(scene, mechanism, theta_kind,
                                         gaunt):
    _, _, port, ref = _both(scene, mechanism, theta_kind, gaunt)
    for key in ("flux_o", "flux_x", "tau_o", "tau_x", "freqs_ghz"):
        assert port[key].dtype == np.float64, key
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-9, atol=0,
                                   err_msg=key)
    assert np.isfinite(port["flux_o"]).all()
    assert (port["flux_o"] + port["flux_x"]).max() > 0


def test_reference_keeps_float64():
    """The optically thin slab of tests/test_grff.py:44-56 agrees with the
    JAX reference to 1e-12, which float32 arithmetic anywhere (such as
    make_voxel_update's pinned constants) could not."""
    ds = np.full((1, 1), 1e8)
    args = (ds, ds * 0 + 2e6, ds * 0 + 1e6, ds * 0, ds > 0, np.array([5e8]),
            AREA)
    res = grff_transfer_reference(*args, mechanism=1)
    ref = jax_reference(*args, mechanism=1)
    assert res["flux_o"][0, 0] > 0
    np.testing.assert_allclose(res["flux_o"], ref["flux_o"], rtol=1e-12)


@pytest.mark.parametrize("mechanism", [1, 5, 7])
@pytest.mark.parametrize("scene", ["parity", "gr_layers"])
def test_float32_transfer_within_one_percent(scene, mechanism):
    """The port's float32 grff_transfer against its float64 reference: T_b
    within 1% wherever the reference's T_b is above 1e-6 of its largest
    (per-voxel theta, as the ray map's theta_mode='los')."""
    args, kw, ref, _ = _both(scene, mechanism, "per_voxel", "dulk")
    res = grff_transfer(*args, device="cpu", **kw)
    freqs = args[5][None, :]
    tb = tb_from_sfu((res.flux_o + res.flux_x).double().numpy(), freqs, AREA)
    tb_ref = tb_from_sfu(ref["flux_o"] + ref["flux_x"], freqs, AREA)
    scale = np.maximum(tb_ref, tb_ref.max() * 1e-6)
    assert np.max(np.abs(tb - tb_ref) / scale) < 0.01
