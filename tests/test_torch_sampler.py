"""The port's LOS sampler against the JAX package's on the fixture of
tests/test_sampler.py: fills, validity, ds anchored at the ray start,
both cos(theta) branches (wave vectors and record-to-record directions)
and los_from_records."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu import sampler as jsam
from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu_torch import sampler as psam
from raytracinggrff_tpu_torch.grids import UniformGrid

torch.set_num_threads(1)


def _case(seed):
    """Linear fields on a 33^3 cube, straight records with some out of
    bounds, S = 0 and S = NaN holes, random wave vectors and a B vector."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-1.0, 1.0, 33, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    f32 = np.float32
    fields = dict(ne=(x + y + z).astype(f32),
                  te=(x * x + 2.0 * y + 3.0 * z).astype(f32),
                  b=(2.0 * x - y + 0.5 * z).astype(f32),
                  bx=(0.3 + 0.5 * y).astype(f32), by=(x - z).astype(f32),
                  bz=(0.2 * x * y - 0.4).astype(f32))
    n_steps, n_rays = 48, 96
    origin = rng.uniform(-0.8, 0.8, (n_rays, 3)).astype(f32)
    dirs = rng.normal(size=(n_rays, 3)).astype(f32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    s = (np.arange(n_steps, dtype=f32) * 0.03)[:, None]
    r_record = origin[None] + s[:, :, None] * dirs[None]
    r_record[-5:, :8, 0] = 2.5                 # out of bounds
    r_record[10, 3] = np.nan                   # non-finite position
    s_arr = np.ones((n_steps, n_rays), f32)
    s_arr[::9, ::7] = 0.0
    s_arr[::13, ::11] = np.nan
    k_record = rng.normal(size=(n_steps, n_rays, 3)).astype(f32)
    k_record[:, 0] = 0.0                       # zero k -> cos = 0
    return g, fields, r_record, s_arr, origin, k_record


def _tables(g, f, bvec):
    jgrid = JaxGrid.from_arrays(g, g, g)
    pgrid = UniformGrid.from_arrays(g, g, g)
    extra = (f["bx"], f["by"], f["bz"]) if bvec else None
    jt = jsam.pack_model_table(f["ne"], f["te"], f["b"], bvec=extra)
    pt = psam.pack_model_table(
        *(torch.as_tensor(f[k]) for k in ("ne", "te", "b")),
        bvec=None if extra is None else tuple(torch.as_tensor(c)
                                              for c in extra))
    return jgrid, pgrid, jt, pt


def _assert_los_equal(p, j, r_sun_cm):
    """Fields to rtol 2e-6, ds to rtol 2e-6 + an atol of 1e-6 R_sun, the
    mask exactly."""
    np.testing.assert_array_equal(p.valid_mask.numpy(),
                                  np.asarray(j.valid_mask))
    for name in ("ne", "te", "b", "s"):
        np.testing.assert_allclose(getattr(p, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=2e-6,
                                   atol=2e-6, err_msg=name)
    np.testing.assert_allclose(p.ds.numpy(), np.asarray(j.ds), rtol=2e-6,
                               atol=1e-6 * r_sun_cm)


@pytest.mark.parametrize("bvec,with_k", [(False, False), (True, True),
                                         (True, False)])
def test_sample_model_with_rays_matches_jax(bvec, with_k):
    g, f, r_record, s_arr, start, k_record = _case(1 + bvec + with_k)
    jgrid, pgrid, jt, pt = _tables(g, f, bvec)
    k = k_record if with_k else None
    j = jsam.sample_model_with_rays(jt, jgrid, r_record, s_arr, start,
                                    k_record=k)
    p = psam.sample_model_with_rays(pt, pgrid, r_record, s_arr, start,
                                    k_record=k)
    _assert_los_equal(p, j, 6.957e10)
    valid = p.valid_mask.numpy()
    inb = np.all(np.abs(r_record) <= 1.0, axis=-1)
    oob = valid & ~inb
    assert oob.any() and not valid[::9, ::7].any()
    np.testing.assert_array_equal(p.ne.numpy()[oob], 0.0)
    np.testing.assert_array_equal(p.te.numpy()[oob], 1e4)
    if bvec:
        np.testing.assert_allclose(p.cos_theta.numpy(),
                                   np.asarray(j.cos_theta), atol=2e-6)
        assert np.nanmax(np.abs(p.cos_theta.numpy())) <= 1.0
        if with_k:
            np.testing.assert_array_equal(p.cos_theta.numpy()[:, 0], 0.0)
    else:
        assert p.cos_theta is None and j.cos_theta is None


def test_arrays_wrapper_matches_jax():
    g, f, r_record, s_arr, start, _ = _case(4)
    args = (g, g, g, f["ne"], f["te"], f["b"], r_record, s_arr, start)
    j = jsam.sample_model_with_rays_arrays(*args, r_sun_cm=1.0)
    p = psam.sample_model_with_rays_arrays(*args, r_sun_cm=1.0,
                                           device="cpu")
    assert set(p) == set(j)
    for key in j:
        np.testing.assert_allclose(p[key].numpy(), np.asarray(j[key]),
                                   rtol=2e-6, atol=2e-6, err_msg=key)


def test_los_from_records_matches_jax():
    g, f, r_record, s_arr, start, _ = _case(5)
    rng = np.random.default_rng(5)
    ne, te, b = (rng.uniform(1.0, 2.0, s_arr.shape).astype(np.float32)
                 for _ in range(3))
    j = jsam.los_from_records(r_record, s_arr, ne, te, b, start)
    p = psam.los_from_records(*(torch.as_tensor(a) for a in
                                (r_record, s_arr, ne, te, b, start)))
    _assert_los_equal(p, j, 6.957e10)
    assert p.cos_theta is None


def test_cos_theta_signed_matches_jax():
    rng = np.random.default_rng(6)
    k = rng.normal(size=(50, 3)).astype(np.float32)
    bv = rng.normal(size=(50, 3)).astype(np.float32)
    bv[:5] = 0.0
    ref = np.asarray(jsam.cos_theta_signed(jnp.asarray(k), jnp.asarray(bv)))
    got = psam.cos_theta_signed(torch.as_tensor(k), torch.as_tensor(bv))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-7)
    np.testing.assert_array_equal(got.numpy()[:5], 0.0)
