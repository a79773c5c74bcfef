"""The port's public surface against the JAX package's: every public name
of raytracinggrff_tpu has a counterpart, and sph_to_cart,
trace_rays_from_cube (on the CPU) and load_mas_var agree with the JAX
functions."""

import numpy as np
import pytest
import torch

import raytracinggrff_tpu as jpkg
import raytracinggrff_tpu_torch as ppkg
from raytracinggrff_tpu.coords import sph_to_cart as jax_sph_to_cart
from raytracinggrff_tpu.mas.model import MASModel as JaxModel
from raytracinggrff_tpu.mas.model import load_mas_var as jax_load_mas_var
from raytracinggrff_tpu.tracer import (
    trace_rays_from_cube as jax_trace_rays_from_cube)
from raytracinggrff_tpu_torch.coords import sph_to_cart
from raytracinggrff_tpu_torch.mas.model import (MASModel, load_mas_var,
                                                synthetic_mas_model)
from raytracinggrff_tpu_torch.tracer import trace_rays_from_cube

torch.set_num_threads(1)
# the reference-compatible aliases of raytracinggrff_tpu/__init__.py:67-75
JAX_ALIASES = ("ray_trace", "trace_ray", "load_mas_var_filtered",
               "resample_to_xyz_cube", "trace_los_cpu", "trace_los_gpu",
               "trace_los_gpu_cupy", "trace_los_dispatch", "ray_trace_gpu")


@pytest.mark.parametrize("name", sorted(set(jpkg.__all__) | set(JAX_ALIASES)))
def test_every_public_jax_name_has_a_counterpart(name):
    """In the port under the same name, or in its documented mapping of the
    names of the JAX TPU segment loop (whose targets the port exports, or
    None)."""
    assert hasattr(jpkg, name), name
    if name in ppkg.TPU_ONLY_NAMES:
        target = ppkg.TPU_ONLY_NAMES[name]
        assert target is None or target in ppkg.__all__, target
        assert name not in ppkg.__all__
    else:
        assert name in ppkg.__all__ and hasattr(ppkg, name), name


def test_aliases_point_where_jax_points():
    for name in JAX_ALIASES:
        assert getattr(ppkg, name).__name__ == getattr(jpkg, name).__name__


def test_sph_to_cart_matches_jax():
    rng = np.random.default_rng(2)
    r, colat, lon = (rng.uniform(1.0, 3.0, 50), rng.uniform(0, np.pi, 50),
                     rng.uniform(0, 2 * np.pi, 50))
    port = sph_to_cart(*(torch.as_tensor(a) for a in (r, colat, lon)))
    ref = jax_sph_to_cart(r, colat, lon, xp=np)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("crosssections", [False, True])
def test_trace_rays_from_cube_matches_jax(crosssections):
    """The reference signature on a refracting cube with a NaN node (read as
    0), on the CPU, against the JAX XLA tracer: positions to 1e-5 and S to
    the record-row bar of tests/test_pallas_trace.py:52-65."""
    axis = np.linspace(-2.0, 2.0, 33)
    x, y, z = np.meshgrid(axis, axis, axis, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    wpe = (0.9 * 2 * np.pi * 80e6 * np.exp(-(r - 1.0) / 0.6)).astype(
        np.float32)
    wpe[r < 1.0] = 0.9 * 2 * np.pi * 80e6
    wpe[0, 0, 0] = np.nan
    rng = np.random.default_rng(4)
    n = 12
    xs, ys = rng.uniform(-0.8, 0.8, n), rng.uniform(-0.8, 0.8, n)
    zs = np.full(n, 1.9)
    kvec = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    args = (wpe, axis, axis, axis, 80e6, xs, ys, zs, kvec, 5e-3, 95, 10,
            crosssections)
    r_p, s_p = trace_rays_from_cube(*args, device="cpu")
    r_j, s_j = jax_trace_rays_from_cube(*args)
    assert tuple(r_p.shape) == (10, n, 3) and tuple(s_p.shape) == (10, n)
    np.testing.assert_allclose(r_p.numpy(), np.asarray(r_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=5e-3,
                               atol=5e-4)
    assert np.ptp(r_p[:, :, 2].numpy()) > 0.1       # the rays move


def test_load_mas_var_matches_jax(tmp_path):
    path = synthetic_mas_model(tmp_path / "m", nphi=12, ntheta=9, nr=10)
    for name in ("rho", "br"):
        port = load_mas_var(MASModel(path), name)
        ref = jax_load_mas_var(JaxModel(path), name)
        np.testing.assert_array_equal(np.asarray(port.data),
                                      np.asarray(ref.data))
        for axis in ("phi", "theta", "r"):
            np.testing.assert_array_equal(np.asarray(getattr(port, axis)),
                                          np.asarray(getattr(ref, axis)))
