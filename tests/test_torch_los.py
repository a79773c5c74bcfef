"""The port's straight-LOS chain and map utilities against the JAX
package: the z grids, spherical sampling of a MAS variable,
resample_mas_los, synthetic_ff, the three CLIs at a tiny size on the
CPU, NaN patching (sequential and simultaneous) and the beam."""

import numpy as np
import pytest
import torch

from raytracinggrff_tpu import grids as jgrids
from raytracinggrff_tpu import pipeline as jpipe
from raytracinggrff_tpu.mas.model import MASModel as JaxModel
from raytracinggrff_tpu.mas.model import synthetic_mas_model
from raytracinggrff_tpu.utils import beam as jbeam
from raytracinggrff_tpu.utils import nanpatch as jnan
from raytracinggrff_tpu_torch import grids as pgrids
from raytracinggrff_tpu_torch import pipeline as ppipe
from raytracinggrff_tpu_torch.cli import compare_los_raytracing as pcmp
from raytracinggrff_tpu_torch.cli import resample_los as plos_cli
from raytracinggrff_tpu_torch.cli import synthetic_ff as pff_cli
from raytracinggrff_tpu_torch.mas.model import MASModel
from raytracinggrff_tpu_torch.utils import beam as pbeam
from raytracinggrff_tpu_torch.utils import nanpatch as pnan

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corona(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "corona"
    synthetic_mas_model(path, nphi=36, ntheta=25, nr=40)
    return path


@pytest.fixture(scope="module")
def los_pair(corona):
    """The same small LOS resampling through both packages."""
    kw = dict(n_pix=12, n_z=60, dz0=8e-3, verbose=False)
    return (ppipe.resample_mas_los(corona, device="cpu", **kw),
            jpipe.resample_mas_los(corona, **kw))


def test_z_grids_equal_jax():
    for n_z, dz0 in ((400, 3e-4), (37, 2e-3)):
        for a, b in zip(pgrids.variable_z_grid(n_z, dz0),
                        jgrids.variable_z_grid(n_z, dz0)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(pgrids.linear_z_grid(50, (0.5, 3.0)),
                    jgrids.linear_z_grid(50, (0.5, 3.0))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="7e-4"):
        pgrids.variable_z_grid(10, 7e4)


def test_sample_sph_matches_jax(corona):
    """Random queries with r outside the mesh (-> NaN), colatitudes past
    the poles (clamped) and longitudes over three periods: equal NaN
    pattern and rtol 1e-5 against JAX; phi + 2 pi gives the same value."""
    rng = np.random.default_rng(0)
    n = 4000
    r = rng.uniform(0.6, 6.6, n).astype(np.float32)
    colat = rng.uniform(-0.1, np.pi + 0.1, n).astype(np.float32)
    phi = rng.uniform(-7.0, 14.0, n).astype(np.float32)
    for name in ("rho", "br"):
        pv = MASModel(corona)[name]
        jv = JaxModel(corona)[name]
        got = pv.sample_sph(r, colat, phi, device="cpu").numpy()
        ref = np.asarray(jv.sample_sph(r, colat, phi))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        assert np.isnan(got).any() and np.isfinite(got).mean() > 0.7
        np.testing.assert_allclose(got, ref, rtol=1e-5, equal_nan=True)
        shifted = pv.sample_sph(r, colat, phi + np.float32(2 * np.pi),
                                device="cpu").numpy()
        np.testing.assert_allclose(shifted, got, rtol=1e-4, equal_nan=True)
    lon = rng.uniform(0.0, 360.0, 50)
    lat = rng.uniform(-80.0, 80.0, 50)
    rr = rng.uniform(1.1, 5.0, 50)
    np.testing.assert_allclose(
        MASModel(corona)["t"].sample_at_coords(lon, lat, rr,
                                               device="cpu").numpy(),
        np.asarray(JaxModel(corona)["t"].sample_at_coords(lon, lat, rr)),
        rtol=1e-5)


def test_resample_mas_los_matches_jax(los_pair, tmp_path, corona):
    """Float64 outputs with the JAX NaN pattern and finite values to rtol
    1e-5; the linear z grid and the all-NaN error as in JAX."""
    port, ref = los_pair
    assert set(port) == set(ref)
    for key in ref:
        assert port[key].dtype == np.float64, key
        assert port[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(np.isnan(port[key]),
                                      np.isnan(ref[key]), err_msg=key)
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-5,
                                   equal_nan=True, err_msg=key)
    # the far ends of the lines of sight leave the 6 R_sun mesh
    assert 0.02 < np.isnan(port["Ne_LOS"]).mean() < 0.5
    assert np.isfinite(port["Ne_LOS"][6, 6, :30]).all()
    kw = dict(n_pix=4, n_z=20, variable_spacing_z=False, z_range=(0.0, 2.0),
              phi0_offset=0.0, verbose=False)
    out = tmp_path / "los.npz"
    lin = ppipe.resample_mas_los(corona, out_path=out, device="cpu", **kw)
    lin_ref = jpipe.resample_mas_los(corona, **kw)
    np.testing.assert_allclose(lin["B_LOS"], lin_ref["B_LOS"], rtol=1e-5,
                               equal_nan=True)
    assert set(np.load(out).files) == set(lin)
    with pytest.raises(RuntimeError, match="dz0"):
        ppipe.resample_mas_los(corona, n_pix=3, n_z=4, dz0=1.0, device="cpu",
                               verbose=False, x_range=(5.0, 6.0),
                               y_range=(5.0, 6.0))


@pytest.mark.parametrize("mechanism", [5, 1])
def test_synthetic_ff_matches_jax(los_pair, tmp_path, mechanism):
    """T_b to rtol 1e-4 and V/I to atol 1e-6 against JAX on the same LOS
    data, and the .npz suffix rule."""
    port_los, _ = los_pair
    out = tmp_path / "emission"
    port = ppipe.synthetic_ff(port_los, 300e6, 3, 0.2, out_path=out,
                              mechanism=mechanism, verbose=False,
                              device="cpu")
    ref = jpipe.synthetic_ff(port_los, 300e6, 3, 0.2, mechanism=mechanism,
                             verbose=False)
    np.testing.assert_allclose(port["emission_cube"], ref["emission_cube"],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"],
                               ref["emission_polVI_cube"], atol=1e-6)
    tb = port["emission_cube"]
    assert tb.shape == (12, 12, 3) and 1e5 < tb[6, 6, 0] < 3e6
    assert (tmp_path / "emission.npz").exists()


def test_los_clis_on_cpu(corona, tmp_path, monkeypatch):
    """resample_los then synthetic_ff, with plots, at a tiny size."""
    monkeypatch.chdir(tmp_path)
    assert plos_cli.main(["-m", str(corona), "-n", "8", "-z", "40", "-d",
                          "2e-3", "--phi0-offset", "0", "-o", "LOS.npz",
                          "--device", "cpu", "-q"]) == 0
    assert (tmp_path / "LOS_2D_slices.png").exists()
    assert pff_cli.main(["-i", "LOS.npz", "-o", "emission_map", "-f",
                         "300e6", "-n", "2", "-s", "0.2", "--device", "cpu",
                         "-q"]) == 0
    data = np.load(tmp_path / "emission_map.npz")
    assert data["emission_cube"].shape == (8, 8, 2)
    assert np.all(np.isfinite(data["emission_cube"]))
    assert (tmp_path / "emission_map.png").exists()
    assert (tmp_path / "emission_map_Tb_VI.png").exists()
    with pytest.raises(ValueError, match="dz0"):
        plos_cli.main(["-m", str(corona), "-d", "7e4", "--device", "cpu",
                       "-q", "-p"])


def test_compare_los_raytracing_cli_on_cpu(corona, tmp_path):
    """One low-band frequency at a tiny size (5 MHz: the fewest steps the
    scaled parameters allow), then --plot-only from the written .npz
    files."""
    out = tmp_path / "cmp"
    argv = ["-m", str(corona), "-n", "4", "--freqs-mhz", "5", "-f", "1.5",
            "--grid-n", "20", "--grid-extent", "2.5", "--z-observer", "2.5",
            "-o", str(out), "--device", "cpu", "-q"]
    pcmp.main(argv)
    ray = np.load(out / "ray_5MHz.npz")["emission_cube"]
    los = np.load(out / "los_5MHz.npz")["emission_cube"]
    assert ray.shape == los.shape == (4, 4, 1)
    assert np.all(np.isfinite(ray)) and np.all(np.isfinite(los))
    png = out / "compare_LOS_raytracing.png"
    png.unlink()
    pcmp.main(argv + ["--plot-only", "--plot-consider-beam",
                      "--beam-factor", "1e6"])
    assert png.exists()
    p = pcmp.frequency_scaled_params(30e6)
    assert (p["n_steps"], p["record_stride"], p["n_z"]) == (2191, 9, 219)


def test_nan_patch_sequential_matches_jax():
    """The reference's in-pass propagation ([1, nan, nan, 4] ->
    [1, 2.5, 3.25, 4]) and equality with JAX on random 2D/3D maps."""
    a = np.array([[1.0, np.nan, np.nan, 4.0]])
    np.testing.assert_array_equal(pnan.patch_nan_emission_map(a),
                                  [[1.0, 2.5, 3.25, 4.0]])
    rng = np.random.default_rng(2)
    m = rng.uniform(1e5, 1e6, (20, 24, 2))
    m[rng.random(m.shape) < 0.2] = np.nan
    m[5:9, 3:10, 0] = np.nan
    np.testing.assert_array_equal(pnan.patch_nan_emission_map(m),
                                  jnan.patch_nan_emission_map(m))
    inplace = m[:, :, 0].copy()
    out = pnan.patch_nan_emission_map(inplace, inplace=True)
    assert out is inplace and np.isfinite(inplace).all()


def test_nan_patch_sim_matches_jax():
    """The simultaneous variant against JAX's (which runs in float32) to
    rtol 1e-6; isolated NaNs equal the sequential patch."""
    rng = np.random.default_rng(3)
    m = rng.uniform(1e5, 1e6, (20, 24, 2))
    m[rng.random(m.shape) < 0.25] = np.nan
    m[4:12, 6:15, 1] = np.nan
    got = pnan.patch_nan_emission_map_sim(m, device="cpu")
    np.testing.assert_allclose(got, jnan.patch_nan_emission_map_sim(m),
                               rtol=1e-6)
    iso = rng.uniform(1.0, 2.0, (9, 9))
    iso[[2, 4, 6], [3, 5, 1]] = np.nan
    np.testing.assert_allclose(
        pnan.patch_nan_emission_map_sim(iso, device="cpu"),
        pnan.patch_nan_emission_map(iso), rtol=1e-12)
    all_nan = np.full((3, 4), np.nan)
    assert np.isnan(pnan.patch_nan_emission_map_sim(all_nan,
                                                    device="cpu")).all()


@pytest.mark.parametrize("sigma", [0.0, 1.3, 3.0])
def test_beam_matches_jax(sigma):
    """The FFT Gaussian against JAX's (float32) to atol 1e-5 of the peak;
    flux is kept and NaN counts as zero."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0.0, 1e6, (32, 30))
    img[3, 4] = np.nan
    got = pbeam.gaussian_beam_convolve(img, sigma, device="cpu").numpy()
    ref = np.asarray(jbeam.gaussian_beam_convolve(img, sigma))
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.nanmax(img))
    np.testing.assert_allclose(got.sum(), np.nansum(img), rtol=1e-10)
