"""The port's MAS input against the JAX package: HDF4 files cross-read by
both copies of the reader, spherical interpolation and cube resampling on
a small synthetic model, and prepare_cubes with the B-vector cubes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu.grids import UniformGrid as JaxGrid
from raytracinggrff_tpu.mas import hdf4 as jhdf4
from raytracinggrff_tpu.mas import model as jmodel
from raytracinggrff_tpu.pipeline import prepare_cubes as jax_prepare
from raytracinggrff_tpu_torch.grids import UniformGrid
from raytracinggrff_tpu_torch.mas import hdf4 as phdf4
from raytracinggrff_tpu_torch.mas import model as pmodel
from raytracinggrff_tpu_torch.ops import resample
from raytracinggrff_tpu_torch.pipeline import prepare_cubes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("mas")
    jpath = jmodel.synthetic_mas_model(root / "jax", nphi=16, ntheta=13,
                                       nr=24)
    ppath = pmodel.synthetic_mas_model(root / "port", nphi=16, ntheta=13,
                                       nr=24)
    return jpath, ppath


def test_synthetic_models_are_byte_identical(models):
    jpath, ppath = models
    names = sorted(p.name for p in jpath.iterdir())
    assert names == sorted(p.name for p in ppath.iterdir())
    assert len(names) == 5
    for name in names:
        assert (jpath / name).read_bytes() == (ppath / name).read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_hdf4_round_trip_across_copies(tmp_path, dtype):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((5, 4, 3)).astype(dtype)
    scales = [np.linspace(0, 6, 5), np.linspace(0.1, 3, 4),
              np.linspace(1, 2, 3)]
    for writer, name in ((jhdf4.write_hdf4_sds, "jax.hdf"),
                         (phdf4.write_hdf4_sds, "port.hdf")):
        writer(tmp_path / name, data, scales=scales, label="x")
        for reader in (jhdf4.read_hdf4_sds, phdf4.read_hdf4_sds):
            sds = reader(tmp_path / name)[0]
            np.testing.assert_array_equal(sds.data, data)
            for a, b in zip(sds.scales, scales):
                np.testing.assert_allclose(a, b)


def test_model_variables_and_axes(models):
    jpath, ppath = models
    jm, pm = jmodel.MASModel(jpath), pmodel.MASModel(ppath)
    assert pm.variables == jm.variables == ["bp", "br", "bt", "rho", "t"]
    assert pm.temperature_variable() == "t"
    for v in ("rho", "br"):
        for attr in ("data", "phi", "theta", "r"):
            np.testing.assert_array_equal(getattr(pm[v], attr),
                                          getattr(jm[v], attr))
    with pytest.raises(KeyError):
        pm["vr"]
    with pytest.raises(FileNotFoundError):
        pmodel.MASModel(jpath / "missing")


def test_interp_sph_matches_jax(models):
    var_j = jmodel.MASModel(models[0])["rho"]
    var_p = pmodel.MASModel(models[1])["rho"]
    rng = np.random.default_rng(2)
    n = 5000
    q = [rng.uniform(0.9, 6.2, n), rng.uniform(-0.1, np.pi + 0.1, n),
         rng.uniform(-7.0, 13.0, n)]
    q = [a.astype(np.float32) for a in q]
    q[0][:3] = [np.nan, 0.5, 7.0]          # NaN and both r out of range
    ref = np.asarray(jmodel._interp_sph(*var_j.device_arrays(),
                                        *map(jnp.asarray, q)))
    out = resample.sample_sph_plain(*var_p.device_arrays("cpu"),
                                    *map(torch.as_tensor, q)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    assert np.isnan(out[:3]).all()
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-5)


@pytest.mark.parametrize("phi0,fill", [(0.0, None), (24.0, 0.0)])
def test_resample_var_to_cube_matches_jax(models, phi0, fill):
    grid_j = JaxGrid.cube(2.5, 19)
    grid_p = UniformGrid.cube(2.5, 19)
    var_j = jmodel.MASModel(models[0])["t"]
    var_p = pmodel.MASModel(models[1])["t"]
    ref = np.asarray(jmodel.resample_var_to_cube(var_j, grid_j, phi0,
                                                 fill_nan=fill))
    out = pmodel.resample_var_to_cube(var_p, grid_p, phi0, fill_nan=fill,
                                      device="cpu", chunk=4).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    assert ok.mean() > 0.5
    np.testing.assert_allclose(out[ok], ref[ok], rtol=1e-5)


def test_prepare_cubes_matches_jax(models):
    grid_j = JaxGrid.cube(2.5, 21)
    ref = jax_prepare(jmodel.MASModel(models[0]), grid_j, 10.0,
                      verbose=False, keep_bvec=True)
    out = prepare_cubes(pmodel.MASModel(models[1]),
                        UniformGrid.cube(2.5, 21), 10.0, verbose=False,
                        keep_bvec=True, device="cpu")
    assert set(out) == set(ref) == {"omega_pe", "ne", "te", "b", "bvec"}
    for key in ("omega_pe", "ne", "te", "b"):
        assert out[key].dtype == torch.float32
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-30)
    for a, b in zip(out["bvec"], ref["bvec"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_multi_timestep_selection_matches_jax(tmp_path):
    """A two-timestep directory (tests/test_mas.py:132-150; the second
    step unmodulated and with twice the field, so that rho and B differ
    between the steps) read through both packages: n_timesteps,
    at_time(1)'s five variables array for array, IndexError past the last
    step, and prepare_cubes(at_time(1)) at the tolerance of
    test_prepare_cubes_matches_jax."""
    small = dict(nphi=16, ntheta=13, nr=24)
    path = pmodel.synthetic_mas_model(tmp_path / "series", timestep=1,
                                      **small)
    pmodel.synthetic_mas_model(path, timestep=2, modulated=False,
                               b0_gauss=5.0, **small)
    jm, pm = jmodel.MASModel(path), pmodel.MASModel(path)
    names = ("rho", "t", "br", "bt", "bp")
    for v in names:
        assert pm.n_timesteps(v) == jm.n_timesteps(v) == 2
    pm1, jm1 = pm.at_time(1), jm.at_time(1)
    assert isinstance(pm1, pmodel.MASModel) and pm1.timestep == 1
    assert pm.timestep == 0 and pm1.path == pm.path
    for v in names:
        for attr in ("data", "phi", "theta", "r"):
            np.testing.assert_array_equal(getattr(pm1[v], attr),
                                          getattr(jm1[v], attr))
    assert not np.array_equal(pm1["rho"].data, pm["rho"].data)
    np.testing.assert_allclose(np.abs(pm1["br"].data).max(),
                               2.0 * np.abs(pm["br"].data).max(), rtol=1e-6)
    for model in (pm.at_time(2), jm.at_time(2)):
        with pytest.raises(IndexError):
            model["rho"]
    data, phi, _, _ = pm1["t"].device_arrays("cpu", dtype=torch.float64)
    assert data.dtype == phi.dtype == torch.float64
    np.testing.assert_array_equal(data.numpy(), pm1["t"].data)

    ref = jax_prepare(jm1, JaxGrid.cube(2.5, 21), 10.0, verbose=False)
    out = prepare_cubes(pm1, UniformGrid.cube(2.5, 21), 10.0, verbose=False,
                        device="cpu")
    for key in ("omega_pe", "ne", "te", "b"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-5, atol=1e-30)
    first = prepare_cubes(pm, UniformGrid.cube(2.5, 21), 10.0,
                          verbose=False, device="cpu")
    assert not torch.equal(first["ne"], out["ne"])
