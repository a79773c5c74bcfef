"""The port's run_ray_tracing_emission (plain torch on the CPU) against the
JAX pipeline with the XLA tracer, on the scenes of
tests/test_streamed_pipeline.py, tests/test_pipeline.py and
tests/test_theta_los.py: theta_mode='los', gyroresonance, and the plot,
beam and NaN-patch options."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinggrff_tpu.mas.model import synthetic_mas_model
from raytracinggrff_tpu.pipeline import (
    RayEmissionConfig as JaxConfig, run_ray_tracing_emission as jax_run)
from raytracinggrff_tpu_torch.cli.ray_tracing_emission import main as cli_main
from raytracinggrff_tpu_torch.pipeline import (
    RayEmissionConfig, config_from_jax, cubes_from_numpy,
    run_ray_tracing_emission)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cubes():
    from raytracinggrff_tpu.grids import UniformGrid
    grid = UniformGrid.cube(2.5, 40)
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    ne = np.where(r >= 1.0, 4.2e4 * 10 ** (4.32 / np.maximum(r, 0.9)),
                  0.0).astype(np.float32)
    return {
        "omega_pe": (8.93e3 * np.sqrt(ne) * 2 * np.pi).astype(np.float32),
        "ne": ne,
        "te": np.full_like(ne, 1.4e6),
        "b": (2.0 / np.maximum(r, 0.9) ** 3).astype(np.float32),
    }


@pytest.fixture(scope="module")
def corona(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "corona"
    synthetic_mas_model(path, nphi=36, ntheta=25, nr=40)
    return path


def _assert_maps_agree(port, ref, min_lit=20):
    """Lit pixels (> 1e4 K in both) to rtol 5e-3 and V/I to atol 1e-4,
    the bar of tests/test_streamed_pipeline.py:45-50."""
    a = ref["emission_cube"]
    b = port["emission_cube"]
    lit = (a > 1e4) & (b > 1e4)
    assert lit.sum() > min_lit
    np.testing.assert_allclose(b[lit], a[lit], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"][lit],
                               ref["emission_polVI_cube"][lit], atol=1e-4)


def _angle_less_rays(ref):
    """The records of a theta_mode='los' JAX XLA map that are valid but
    have no angle: the step at which a ray leaving the cube froze (S > 0,
    k NaN, so cos theta is NaN). The JAX pipeline keeps such a record and
    its NaN angle can zero the pixel; the port treats it as invalid.
    Returns the (n_pix, n_pix) mask of the rays that hold one and the
    (n_records, n_rays) mask of the records."""
    sampled = ref["_sampled"]
    bad = (np.asarray(sampled.valid_mask)
           & ~np.isfinite(np.asarray(sampled.cos_theta)))
    n_pix = ref["emission_cube"].shape[0]
    return bad.any(axis=0).reshape(n_pix, n_pix), bad


def _assert_los_maps_agree(port, ref, min_lit=20):
    """theta_mode='los' maps: on every ray without an angle-less record,
    every pixel, zeros included, to rtol 5e-3 in T_b and atol 1e-4 in V/I
    (the bar of tests/test_streamed_pipeline.py:45-50); every pixel the
    JAX map zeroed lies on an angle-less ray. Returns that ray mask."""
    rays, _ = _angle_less_rays(ref)
    a, b = ref["emission_cube"], port["emission_cube"]
    assert (b[~rays] > 1e4).sum() > min_lit
    np.testing.assert_allclose(b[~rays], a[~rays], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"][~rays],
                               ref["emission_polVI_cube"][~rays], atol=1e-4)
    assert rays[np.any(a == 0, axis=2)].all()
    return rays


def _jax_cubes(scene):
    return {k: (tuple(jnp.asarray(c) for c in v) if k == "bvec"
                else jnp.asarray(v)) for k, v in scene.items()}


def test_streamed_scene_matches_jax_xla(cubes):
    common = dict(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=610,
                  record_stride=10, nfreq=2, freq_log_step=0.2,
                  s_input_on=True)
    jcfg = JaxConfig(tracer_backend="xla", **common)
    ref = jax_run(cubes={k: jnp.asarray(v) for k, v in cubes.items()},
                  verbose=False, config=jcfg)
    timings = {}
    port = run_ray_tracing_emission(
        cubes=cubes_from_numpy(cubes, "cpu"), verbose=False,
        config=config_from_jax(jcfg), device="cpu", timings=timings)
    _assert_maps_agree(port, ref)
    np.testing.assert_array_equal(port["frequencies_Hz"],
                                  ref["frequencies_Hz"])
    assert timings["segments"] == 1
    assert {"resample", "trace", "transfer", "finish"} <= set(timings)


def test_numpy_cubes_match_tensors_and_jax():
    """The JAX call's cube dict of numpy arrays goes into the port's call
    as it is: parallel.dryrun.small_map's cubes give the same map as the
    same cubes as tensors (exactly) and as the JAX XLA call on the same
    dict. Its 40 steps stay above the dense corona, so every T_b lies
    below 1e4 K; the bar of _assert_maps_agree (rtol 5e-3 in T_b, atol
    1e-4 in V/I) holds on every pixel instead of the lit ones."""
    from raytracinggrff_tpu_torch.parallel.dryrun import small_map
    cubes, cfg = small_map(nfreq=2)
    assert all(isinstance(v, np.ndarray) for v in cubes.values())
    port = run_ray_tracing_emission(cubes=cubes, config=cfg, verbose=False,
                                    device="cpu")
    tensors = run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                       config=cfg, verbose=False,
                                       device="cpu")
    for key in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(port[key], tensors[key])
    ref = jax_run(cubes=cubes, verbose=False, config=JaxConfig(
        tracer_backend="xla", **dataclasses.asdict(cfg)))
    tb = port["emission_cube"]
    assert tb.shape == (8, 8, 2) and np.all(tb > 0)
    np.testing.assert_allclose(tb, ref["emission_cube"], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"],
                               ref["emission_polVI_cube"], atol=1e-4)


def test_model_path_matches_jax_xla(corona, tmp_path):
    common = dict(n_pix=8, x_fov=1.44, freq_hz=150e6, grid_n=48,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=900,
                  record_stride=10, s_input_on=False, nfreq=1)
    ref = jax_run(model_path=corona, verbose=False,
                  config=JaxConfig(tracer_backend="xla", **common))
    out = tmp_path / "ray_emission.npz"
    # seg_records=40 splits the 90 records into 3 segments
    port = run_ray_tracing_emission(
        model_path=corona, out_path=out, verbose=False, device="cpu",
        config=RayEmissionConfig(seg_records=40, **common))
    _assert_maps_agree(port, ref, min_lit=40)
    tb = port["emission_cube"]
    assert tb.shape == (8, 8, 1) and np.all(np.isfinite(tb))
    on_disk = tb[[2, 2, 5, 5], [2, 5, 2, 5], 0]
    assert np.all(on_disk > 5e5)
    assert np.all(tb[0, :, 0] < on_disk.min())
    data = np.load(out)
    assert set(data.files) == {"emission_cube", "emission_polVI_cube",
                               "frequencies_Hz", "x_coords", "y_coords"}
    np.testing.assert_allclose(data["x_coords"], ref["x_coords"])
    assert port["_sampled"] is None


def test_written_map_equals_the_returned_one(cubes, tmp_path):
    """The .npz of a map (its name given without the suffix) holds the
    returned arrays, and its timings count the write's deflate jobs."""
    timings = {}
    port = run_ray_tracing_emission(
        cubes=cubes, out_path=tmp_path / "map", verbose=False, device="cpu",
        timings=timings, config=RayEmissionConfig(
            n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40, grid_extent=2.5,
            z_observer=2.5, dt=1e-2, n_steps=200, record_stride=10))
    with np.load(tmp_path / "map.npz") as data:
        assert set(data.files) == set(port) - {"_sampled"}
        for k in data.files:
            np.testing.assert_array_equal(data[k], port[k], strict=True)
    assert timings["write_chunks"] >= 1
    assert 1 <= timings["write_threads"] <= timings["write_chunks"]
    assert timings["write"] >= 0.0


@pytest.mark.parametrize("option", [{"mesh": object()}])
def test_mesh_option_must_be_a_ray_mesh(corona, option):
    """A mesh that is not a parallel.mesh.RayMesh (a JAX Mesh, say) is
    refused before any work."""
    with pytest.raises(TypeError, match="RayMesh"):
        run_ray_tracing_emission(model_path=corona, device="cpu",
                                 verbose=False, n_pix=2, n_steps=10,
                                 grid_n=8, **option)


@pytest.mark.parametrize("theta_mode", ["fixed", "los"])
def test_per_step_map_matches_jax_xla(cubes, theta_mode):
    """s_mode='per_step' with s_input_on (each record's source area is its
    last step's S times the pixel area) over three segments, against the
    JAX XLA pipeline's per-step map, at the bars of the cumulative tests;
    the map differs from the cumulative one."""
    from raytracinggrff_tpu.grids import UniformGrid
    scene = dict(cubes)
    if theta_mode == "los":
        scene["bvec"] = _dipole_bvec(UniformGrid.cube(2.5, 40))
    jcfg = JaxConfig(tracer_backend="xla", n_pix=8, x_fov=1.3,
                     freq_hz=150e6, grid_n=40, grid_extent=2.5,
                     z_observer=2.5, dt=1e-2, n_steps=610, nfreq=2,
                     freq_log_step=0.2, s_input_on=True, s_mode="per_step",
                     theta_mode=theta_mode, seg_records=25)
    ref = jax_run(cubes=_jax_cubes(scene), verbose=False, config=jcfg)
    timings = {}
    port = run_ray_tracing_emission(cubes=cubes_from_numpy(scene, "cpu"),
                                    verbose=False, device="cpu",
                                    config=config_from_jax(jcfg),
                                    timings=timings)
    assert timings["segments"] == 3
    if theta_mode == "los":
        _assert_los_maps_agree(port, ref)
    else:
        _assert_maps_agree(port, ref)
    cum = run_ray_tracing_emission(
        cubes=cubes_from_numpy(scene, "cpu"), verbose=False, device="cpu",
        config=config_from_jax(dataclasses.replace(jcfg,
                                                   s_mode="cumulative")))
    lit = port["emission_cube"] > 1e4
    assert np.mean(np.abs(port["emission_cube"][lit]
                          / cum["emission_cube"][lit] - 1) > 1e-3) > 0.5


def _dipole_bvec(grid, b0=4.0):
    """A dipole with its moment along image +y (the MAS polar axis), as in
    tests/test_theta_los.py."""
    x, y, z = np.meshgrid(*grid.axes(), indexing="ij")
    r = np.maximum(np.sqrt(x * x + y * y + z * z), 1e-9)
    c = b0 / np.maximum(r, 0.9) ** 3
    yr = y / r
    return tuple(v.astype(np.float32) for v in
                 (c * 3 * yr * x / r, c * (3 * yr * yr - 1.0),
                  c * 3 * yr * z / r))


@pytest.mark.parametrize("gaunt", ["dulk", "exact"])
def test_theta_los_matches_jax_xla(cubes, gaunt):
    """theta_mode='los' (8-channel records, per-voxel theta from row 7) on
    the streamed scene with a B-vector cube, against the JAX XLA
    pipeline on every pixel of a ray without an angle-less record; the
    map is signed (V/I of both signs)."""
    from raytracinggrff_tpu.grids import UniformGrid
    scene = dict(cubes, bvec=_dipole_bvec(UniformGrid.cube(2.5, 40)))
    jcfg = JaxConfig(tracer_backend="xla", n_pix=8, x_fov=1.3,
                     freq_hz=150e6, grid_n=40, grid_extent=2.5,
                     z_observer=2.5, dt=1e-2, n_steps=610, nfreq=2,
                     freq_log_step=0.2, s_input_on=True, theta_mode="los",
                     gaunt=gaunt)
    ref = jax_run(cubes=_jax_cubes(scene), verbose=False, config=jcfg)
    port = run_ray_tracing_emission(cubes=cubes_from_numpy(scene, "cpu"),
                                    verbose=False, device="cpu",
                                    config=config_from_jax(jcfg))
    _assert_los_maps_agree(port, ref)
    vi = port["emission_polVI_cube"][port["emission_cube"] > 1e4]
    assert vi.min() < -1e-4 and vi.max() > 1e-4


def test_gyroresonance_map_matches_jax_xla(tmp_path):
    """mechanism=7 with theta_mode='los' on a b0_gauss=50 model at 75 MHz,
    where the s = 2-4 layers lie inside the cube, against the JAX XLA
    pipeline on every pixel of a ray without an angle-less record;
    gyroresonance changes most on-disk pixels by more than 1% from
    mechanism=5."""
    model = synthetic_mas_model(tmp_path / "strong", nphi=36, ntheta=25,
                                nr=40, b0_gauss=50.0)
    common = dict(n_pix=8, x_fov=1.44, freq_hz=75e6, grid_n=40,
                  grid_extent=3.0, z_observer=3.0, dt=1.5e-2, n_steps=600,
                  record_stride=10, nfreq=2, freq_log_step=0.05,
                  s_input_on=True, theta_mode="los")
    ref = jax_run(model_path=model, verbose=False,
                  config=JaxConfig(tracer_backend="xla", mechanism=7,
                                   **common))
    port = run_ray_tracing_emission(model_path=model, verbose=False,
                                    device="cpu", config=RayEmissionConfig(
                                        mechanism=7, **common))
    _assert_los_maps_agree(port, ref)
    ff = run_ray_tracing_emission(model_path=model, verbose=False,
                                  device="cpu", config=RayEmissionConfig(
                                      mechanism=5, **common))
    xs = np.linspace(-1.44, 1.44, 8)
    disk = (xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0
    a = port["emission_cube"][disk]
    b = ff["emission_cube"][disk]
    assert np.all(np.isfinite(a)) and np.mean(np.abs(a / b - 1) > 0.01) > 0.5


def test_plots_patch_nan_and_beam_match_jax(corona, tmp_path):
    """save_plots, patch_nan and consider_beam: the .npz agrees with the
    JAX XLA pipeline's, both pngs are written, and the inspection pixel's
    one-column LosSamples agrees with the JAX XLA path's _sampled column
    (positions and fields to rtol 1e-4, the mask exactly)."""
    from raytracinggrff_tpu.utils.plotting import inspection_pixel_index
    common = dict(n_pix=8, x_fov=1.44, freq_hz=150e6, grid_n=48,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=900,
                  record_stride=10, s_input_on=True, nfreq=1)
    options = dict(save_plots=True, patch_nan=True, consider_beam=True,
                   beam_fwhm=0.3, verbose=False)
    ref = jax_run(model_path=corona, out_path=tmp_path / "jax.npz",
                  config=JaxConfig(tracer_backend="xla", **common),
                  **options)
    out = tmp_path / "port.npz"
    port = run_ray_tracing_emission(model_path=corona, out_path=out,
                                    device="cpu",
                                    config=RayEmissionConfig(**common),
                                    **options)
    _assert_maps_agree(dict(np.load(out)), dict(np.load(tmp_path /
                                                        "jax.npz")),
                       min_lit=40)
    assert (tmp_path / "port.png").exists()
    assert (tmp_path / "port_center_pixel.png").exists()
    center = port["_sampled"]
    p = inspection_pixel_index(8)
    valid = np.asarray(ref["_sampled"].valid_mask)[:, p]
    np.testing.assert_array_equal(center.valid_mask[:, 0], valid)
    assert valid.sum() > 20 and center.cos_theta is None
    for name in ("ne", "te", "b", "ds", "s"):
        np.testing.assert_allclose(
            getattr(center, name)[valid, 0],
            np.asarray(getattr(ref["_sampled"], name))[valid, p],
            rtol=1e-4, err_msg=name)


def test_patch_nan_fills_only_failed_pixels(cubes, monkeypatch):
    """patch_nan patches the pixels whose T_b came out non-finite (set
    here by poisoning two rays' fluxes) and leaves zeros and finite
    pixels alone."""
    from raytracinggrff_tpu_torch import pipeline as ppipe
    saved = ppipe._streamed_trace_transfer

    def poisoned(*args, **kw):
        f_o, f_x, n_seg, center = saved(*args, **kw)
        f_o = f_o.clone()
        f_o[[19, 44]] = float("nan")
        return f_o, f_x, n_seg, center

    cfg = RayEmissionConfig(n_pix=8, x_fov=1.3, freq_hz=150e6, grid_n=40,
                            grid_extent=2.5, z_observer=2.5, dt=1e-2,
                            n_steps=610)
    plain = run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                     config=cfg, verbose=False,
                                     device="cpu")
    monkeypatch.setattr(ppipe, "_streamed_trace_transfer", poisoned)
    res = run_ray_tracing_emission(cubes=cubes_from_numpy(cubes, "cpu"),
                                   config=cfg, verbose=False, device="cpu",
                                   patch_nan=True)
    tb, tb0 = res["emission_cube"][:, :, 0], plain["emission_cube"][:, :, 0]
    bad = np.zeros((8, 8), bool)
    bad[[2, 5], [3, 4]] = True
    np.testing.assert_array_equal(tb[~bad], tb0[~bad])
    assert np.all(tb[bad] > 1e4) and np.all(np.isfinite(tb))
    np.testing.assert_allclose(tb[2, 3], np.mean([tb0[2, 2], tb0[2, 4],
                                                  tb0[1, 3], tb0[3, 3]]))


def test_cli_writes_npz(corona, tmp_path):
    out = tmp_path / "cli.npz"
    cli_main(["-m", str(corona), "-n", "4", "--grid-n", "24",
              "--n-steps", "40", "--nfreq", "2", "--freq-log-step", "0.1",
              "--device", "cpu", "--no-plots", "-q", "-o", str(out)])
    data = np.load(out)
    assert data["emission_cube"].shape == (4, 4, 2)
    assert np.all(np.isfinite(data["emission_cube"]))
    np.testing.assert_allclose(data["frequencies_Hz"],
                               [75e6, 75e6 * 10 ** 0.1])


def test_record_without_angle_is_invalid(cubes, monkeypatch):
    """With theta_mode='los', a record whose cos(theta) is NaN (the step at
    which a ray leaving the cube froze: S > 0, k NaN) contributes nothing,
    exactly as if its S were 0, instead of blocking both modes as the JAX
    pipeline's NaN angle does."""
    from raytracinggrff_tpu_torch import pipeline as ppipe
    _, _, start, _ = ppipe.image_ray_starts(2, 1.3, 2.5)
    n_rec = 6
    rec = np.zeros((n_rec, 8, 4), np.float32)
    steps = np.arange(1, n_rec + 1, dtype=np.float32)[:, None]
    for j in range(4):
        rec[:, 0:3, j] = start[j] + steps * np.float32([0.0, 0.0, -0.3])
    rec[:, 3] = 1.0
    rec[:, 4] = np.linspace(2e8, 5e7, n_rec)[:, None]
    rec[:, 5] = 1.2e6
    rec[:, 6] = 8.0
    rec[:, 7] = 0.4
    rec[-1, 3, :2] = 0.0                 # rays 0, 1: last record invalid
    rec[-1, 7, 2:] = np.nan              # rays 2, 3: last record angle-less
    monkeypatch.setattr(ppipe, "iter_trace_segments",
                        lambda *a, **k: iter([torch.as_tensor(rec)]))
    scene = dict(cubes, bvec=(cubes["b"],) * 3)
    res = run_ray_tracing_emission(
        cubes=cubes_from_numpy(scene, "cpu"), verbose=False, device="cpu",
        config=RayEmissionConfig(n_pix=2, x_fov=1.3, freq_hz=150e6,
                                 grid_n=40, grid_extent=2.5, z_observer=2.5,
                                 nfreq=2, freq_log_step=0.2,
                                 theta_mode="los", mechanism=7))
    tb = res["emission_cube"].reshape(4, 2)
    assert np.all(tb > 1e4)
    np.testing.assert_array_equal(tb[2:], tb[:2])


def test_angle_less_records_match_masked_jax(cubes, tmp_path, monkeypatch):
    """The one place the port departs from the JAX pipeline. At 80 MHz
    over 1200 steps, some rays of the dipole scene freeze at the cube exit
    on a record step, so that record keeps S > 0 with a NaN angle; the
    JAX map is 0 on some of them, on disk among them. The port agrees
    with the JAX map on every other pixel, and on every pixel with the
    JAX XLA pipeline whose sampler marks those records invalid, to rtol
    5e-3 in T_b and atol 1e-4 in V/I. With the inspection pixel moved
    onto a zeroed ray, the one-column LosSamples equals that pipeline's
    column: the mask exactly, ne/te/b/ds to rtol 1e-4, cumulative S and
    cos theta to the record-row bars of tests/test_pallas_trace.py:52-65
    (atol 5e-4 with rtol 5e-3, and atol 1e-4)."""
    from raytracinggrff_tpu import pipeline as jpipe
    from raytracinggrff_tpu.grids import UniformGrid
    from raytracinggrff_tpu_torch import pipeline as ppipe
    scene = dict(cubes, bvec=_dipole_bvec(UniformGrid.cube(2.5, 40)))
    jcfg = JaxConfig(tracer_backend="xla", n_pix=8, x_fov=1.3,
                     freq_hz=80e6, grid_n=40, grid_extent=2.5,
                     z_observer=2.5, dt=1e-2, n_steps=1200, nfreq=2,
                     freq_log_step=0.2, s_input_on=True, theta_mode="los")
    ref = jax_run(cubes=_jax_cubes(scene), verbose=False, config=jcfg)
    rays, bad = _angle_less_rays(ref)
    zeroed = np.all(ref["emission_cube"] == 0, axis=2)
    xs = np.linspace(-1.3, 1.3, 8)
    disk = (xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0
    assert (zeroed & disk).any() and (rays & ~zeroed).any()
    # one angle-less record per ray, and it is the ray's last valid one,
    # so marking it invalid leaves every other record's ds as it is
    valid = np.asarray(ref["_sampled"].valid_mask)
    last = valid.shape[0] - 1 - np.argmax(valid[::-1], axis=0)
    np.testing.assert_array_equal(bad[last, np.arange(valid.shape[1])],
                                  rays.reshape(-1))
    assert bad.sum() == rays.sum()

    sample = jpipe.sample_model_with_rays

    def sample_masked(*args, **kw):
        los = sample(*args, **kw)
        usable = los.valid_mask & jnp.isfinite(los.cos_theta)
        return los._replace(valid_mask=usable,
                            ds=jnp.where(usable, los.ds, 0.0))

    monkeypatch.setattr(jpipe, "sample_model_with_rays", sample_masked)
    masked = jax_run(cubes=_jax_cubes(scene), verbose=False, config=jcfg)
    p = int(np.flatnonzero((zeroed & disk).reshape(-1))[0])
    monkeypatch.setattr(ppipe, "inspection_pixel_index", lambda n_pix: p)
    port = run_ray_tracing_emission(
        cubes=cubes_from_numpy(scene, "cpu"), verbose=False, device="cpu",
        config=config_from_jax(jcfg), save_plots=True,
        out_path=tmp_path / "los.npz")

    _assert_los_maps_agree(port, ref)
    assert np.all(port["emission_cube"][zeroed] > 1e4)
    np.testing.assert_allclose(port["emission_cube"],
                               masked["emission_cube"], rtol=5e-3)
    np.testing.assert_allclose(port["emission_polVI_cube"],
                               masked["emission_polVI_cube"], atol=1e-4)

    center, ref_los = port["_sampled"], masked["_sampled"]
    usable = np.asarray(ref_los.valid_mask)[:, p]
    np.testing.assert_array_equal(center.valid_mask[:, 0], usable)
    assert usable.sum() == valid[:, p].sum() - 1
    for name, tol in (("ne", {}), ("te", {}), ("b", {}), ("ds", {}),
                      ("s", {"atol": 5e-4, "rtol": 5e-3}),
                      ("cos_theta", {"atol": 1e-4, "rtol": 0.0})):
        np.testing.assert_allclose(
            np.asarray(getattr(center, name))[usable, 0],
            np.asarray(getattr(ref_los, name))[usable, p],
            **{"rtol": 1e-4, **tol}, err_msg=name)


def test_time_series_map_matches_jax_xla(tmp_path):
    """A MAS time series through the port: at_time(1)'s cubes
    (prepare_cubes) into the map (8^2 pixels, 900 steps, S input on, on
    the CPU), against the JAX XLA pipeline's map of the same directory at
    timestep=1 under the bar of _assert_maps_agree. The port's
    model_path=..., timestep=1 call gives the same map exactly, and step
    0's map differs from step 1's on the disk."""
    from raytracinggrff_tpu_torch.grids import UniformGrid
    from raytracinggrff_tpu_torch.mas.model import MASModel
    from raytracinggrff_tpu_torch.pipeline import prepare_cubes
    small = dict(nphi=36, ntheta=25, nr=40)
    path = synthetic_mas_model(tmp_path / "series", timestep=1, **small)
    synthetic_mas_model(path, timestep=2, modulated=False, **small)
    common = dict(n_pix=8, x_fov=1.44, freq_hz=150e6, grid_n=48,
                  grid_extent=2.5, z_observer=2.5, dt=1e-2, n_steps=900,
                  record_stride=10, s_input_on=True, nfreq=2,
                  freq_log_step=0.1)
    ref = jax_run(model_path=path, timestep=1, verbose=False,
                  config=JaxConfig(tracer_backend="xla", **common))
    cfg = RayEmissionConfig(**common)
    model = MASModel(path)
    assert model.n_timesteps("rho") == 2
    maps = []
    for step in (0, 1):
        cubes = prepare_cubes(model.at_time(step), UniformGrid.cube(2.5, 48),
                              cfg.phi0_offset, verbose=False, device="cpu")
        maps.append(run_ray_tracing_emission(cubes=cubes, config=cfg,
                                             verbose=False, device="cpu"))
    _assert_maps_agree(maps[1], ref, min_lit=40)
    direct = run_ray_tracing_emission(model_path=path, timestep=1,
                                      config=cfg, verbose=False,
                                      device="cpu")
    for key in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(maps[1][key], direct[key])
    xs = np.linspace(-1.44, 1.44, 8)
    disk = (xs[None, :] ** 2 + xs[:, None] ** 2) < 1.0
    a, b = maps[0]["emission_cube"][disk], maps[1]["emission_cube"][disk]
    assert np.all(b > 1e4) and np.max(np.abs(a / b - 1)) > 1e-3
