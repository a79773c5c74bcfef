"""The straight-LOS vs ray-tracing comparison at the high-band presets on
the CPU, at small sizes of the compare_800mhz cell: the LOS chain
(resample_mas_los, synthetic_ff) against the plain LOS reference
(benchmark/reference/los.py), compare_frequency's preset against its
high-band table, a cube whose size is not a multiple of the resample's
16-plane slab (as 520 is not) through prepare_cubes and the trace with
the 800 MHz preset's geometry, and the comparison's spans and the LOS
chain's counts (taken only while a recording and torch.profiler are
active)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.gen.mas import mas_arrays, write_mas_dir  # noqa: E402
from benchmark.reference import los as ref_los  # noqa: E402
from benchmark.reference import map as ref_map  # noqa: E402
from benchmark.reference import scene as ref_scene  # noqa: E402
import raytracinggrff_tpu_torch.cli.compare_los_raytracing as cmp  # noqa: E402
from raytracinggrff_tpu_torch.grids import UniformGrid  # noqa: E402
from raytracinggrff_tpu_torch.mas.model import (  # noqa: E402
    MASModel, scene_arrays)
from raytracinggrff_tpu_torch.ops import resample  # noqa: E402
from raytracinggrff_tpu_torch.pipeline import (  # noqa: E402
    image_ray_starts, prepare_cubes, resample_mas_los,
    run_ray_tracing_emission, synthetic_ff)
from raytracinggrff_tpu_torch.tracer_segments import (  # noqa: E402
    trace_rays_segments)
from raytracinggrff_tpu_torch.utils import profiling  # noqa: E402

SCENE = dict(nphi=16, ntheta=12, nr=14, r_max=6.0, b0_gauss=2.5,
             timestep=2, modulation_amplitude=[0.2, 0.4],
             modulation_phase_rad=[0.0, 6.283185307179586])
# the 800 MHz preset's geometry (x_fov 1.44 over a +-1.45 R_sun cube, the
# observer at 1.44) on a 26^3 cube: 520 / 20, two slabs of 16 and 10
# planes; 300 steps at dt 2e-2 take the rays out through its faces
RAGGED = dict(n_pix=8, x_fov=1.44, freq_hz=800e6, grid_n=26,
              grid_extent=1.45, z_observer=1.44, dt=2e-2, n_steps=300,
              record_stride=5, s_input_on=False, nfreq=1, freq0=800e6,
              freq_log_step=0.0, perturb_ratio=2.0, phi0_offset=0.0,
              mechanism=5, theta_deg=90.0, seg_records=16)
# a small preset of compare_frequency: the 26^3 cube and 64 LOS voxels at
# the 800 MHz preset's dz0 scaled to span the same depth
TINY_PRESET = dict(grid_n=26, grid_extent=1.45, z_observer=1.44, dt=4e-3,
                   n_steps=300, record_stride=5, dz0=9e-5 * 1100 / 64,
                   n_z=64)
LOS_SPANS = {"los_read", "los_scene_upload", "los_sample", "los_download",
             "los_upload", "los_transfer", "los_finish", "los_write"}
LOS_COUNTS = {"los_flagged", "los_taken"}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    arrays, mesh = mas_arrays(SCENE, 2 ** 31 + 11)
    path = write_mas_dir(tmp_path_factory.mktemp("highband") / "corona",
                         arrays, mesh, SCENE["timestep"])
    return arrays, mesh, path


def los_run(n_pix, x_fov, phi0_offset, n_z, dz0):
    return (dict(n_pix=n_pix, x_fov=x_fov, phi0_offset=phi0_offset,
                 freq_hz=800e6),
            dict(n_z=n_z, dz0=dz0, variable_spacing_z=True, nfreq=1,
                 mechanism=5))


@pytest.mark.parametrize("n_pix, x_fov, phi0_offset, n_z, dz0", [
    (8, 1.44, 0.0, 64, 9e-5 * 1100 / 64),
    (10, 2.8, 24.0, 40, 3e-4 * 400 / 40),
    (7, 1.2, -140.0, 90, 1e-3)])
def test_los_chain_equals_the_los_reference(scene, n_pix, x_fov,
                                            phi0_offset, n_z, dz0):
    """resample_mas_los then synthetic_ff, the way compare_frequency runs
    them, against the plain LOS reference at every pixel: equal bit for
    bit, T_b and V/I; the maps hold both disk and limb pixels."""
    arrays, mesh, path = scene
    los = resample_mas_los(str(path), n_pix=n_pix, x_range=(-x_fov, x_fov),
                           y_range=(-x_fov, x_fov), n_z=n_z, dz0=dz0,
                           phi0_offset=phi0_offset, verbose=False,
                           device="cpu")
    em = synthetic_ff(los, 800e6, 1, 0.0, verbose=False, device="cpu")
    run, los_cfg = los_run(n_pix, x_fov, phi0_offset, n_z, dz0)
    pixels = np.arange(n_pix ** 2)
    tb, vi = ref_los.los_pixels(arrays, mesh, run, los_cfg, pixels, "cpu")
    np.testing.assert_array_equal(tb, em["emission_cube"].reshape(-1, 1))
    np.testing.assert_array_equal(vi,
                                  em["emission_polVI_cube"].reshape(-1, 1))
    assert tb.max() > 1e5 and np.isfinite(tb).all()


def test_los_samples_equal_the_program(scene):
    """The reference's samples and ds at a few pixels, on and off the
    disk, equal the LOS data of resample_mas_los."""
    arrays, mesh, path = scene
    run, los_cfg = los_run(9, 1.44, 10.0, 50, 2e-3)
    los = resample_mas_los(str(path), n_pix=9, n_z=50, dz0=2e-3,
                           phi0_offset=10.0, verbose=False, device="cpu")
    pixels = np.array([0, 4, 40, 44, 80])
    ne, te, b, ds = ref_los.los_samples(arrays, mesh, run, los_cfg, pixels,
                                        "cpu", torch.float32)
    for got, key in ((ne, "Ne_LOS"), (te, "Te_LOS"), (b, "B_LOS")):
        np.testing.assert_array_equal(
            got.numpy(), los[key].reshape(81, 50)[pixels], err_msg=key)
    np.testing.assert_array_equal(ds, los["ds_LOS"][0, 0])
    assert np.isfinite(ne.numpy()).all() and ne.numpy().max() > 1e6


def test_los_reference_z_grid_is_the_program_grid():
    from raytracinggrff_tpu_torch.grids import variable_z_grid
    for n_z, dz0 in ((1100, 9e-5), (400, 3e-4), (7, 0.1)):
        for a, b in zip(ref_los.z_grid(n_z, dz0), variable_z_grid(n_z, dz0)):
            np.testing.assert_array_equal(a, b)


def calls_of(monkeypatch):
    """Replace the three pipeline calls compare_frequency makes by
    recorders that return small stand-ins; returns the record."""
    calls = []

    def ray(**kw):
        calls.append(("ray", kw))
        return {"emission_cube": np.zeros((1, 1, 1))}

    def los(*a, **kw):
        calls.append(("los", a, kw))
        return {}

    def ff(*a, **kw):
        calls.append(("ff", a, kw))
        return {"emission_cube": np.zeros((1, 1, 1))}

    monkeypatch.setattr(cmp, "run_ray_tracing_emission", ray)
    monkeypatch.setattr(cmp, "resample_mas_los", los)
    monkeypatch.setattr(cmp, "synthetic_ff", ff)
    return calls


@pytest.mark.parametrize("freq", sorted(cmp.HIGHBAND_PRESETS))
def test_preset_makes_the_highband_calls(monkeypatch, freq):
    """compare_frequency(preset=HIGHBAND_PRESETS[f]) asks the pipelines
    for exactly what highband=True asks for, whatever the grid arguments
    say."""
    calls = calls_of(monkeypatch)
    kw = dict(n_pix=128, x_fov=1.44, phi0_offset=0.0, verbose=False,
              device="cpu")
    cmp.compare_frequency("m", freq, highband=True, **kw)
    cmp.compare_frequency("m", freq, grid_n=64, grid_extent=9.0,
                          z_observer=9.0,
                          preset=cmp.HIGHBAND_PRESETS[freq], **kw)
    assert len(calls) == 6 and calls[:3] == calls[3:]
    cfg = calls[0][1]["config"]
    p = cmp.HIGHBAND_PRESETS[freq]
    assert (cfg.grid_n, cfg.grid_extent, cfg.z_observer, cfg.dt,
            cfg.n_steps, cfg.record_stride) == tuple(
        p[k] for k in ("grid_n", "grid_extent", "z_observer", "dt",
                       "n_steps", "record_stride"))
    assert (calls[1][2]["n_z"], calls[1][2]["dz0"]) == (p["n_z"], p["dz0"])


def test_preset_must_hold_every_key(monkeypatch):
    calls_of(monkeypatch)
    preset = dict(cmp.HIGHBAND_PRESETS[800e6])
    del preset["n_z"]
    with pytest.raises(ValueError, match="n_z"):
        cmp.compare_frequency("m", 800e6, preset=preset, device="cpu",
                              verbose=False)
    with pytest.raises(ValueError, match="nfreq"):
        cmp.compare_frequency("m", 800e6, device="cpu", verbose=False,
                              preset=dict(cmp.HIGHBAND_PRESETS[800e6],
                                          nfreq=3))


def test_preset_may_set_the_segment_length(monkeypatch):
    calls = calls_of(monkeypatch)
    cmp.compare_frequency("m", 800e6, device="cpu", verbose=False,
                          preset=dict(cmp.HIGHBAND_PRESETS[800e6],
                                      seg_records=8))
    cmp.compare_frequency("m", 800e6, device="cpu", verbose=False,
                          highband=True)
    assert calls[0][1]["config"].seg_records == 8
    assert calls[3][1]["config"].seg_records == 64


def test_preset_maps_equal_the_highband_maps(scene, monkeypatch, tmp_path):
    """With a small preset installed as the 800 MHz entry of the table,
    highband=True and preset= write the same two maps."""
    _, _, path = scene
    monkeypatch.setitem(cmp.HIGHBAND_PRESETS, 800e6, dict(TINY_PRESET))
    kw = dict(n_pix=8, x_fov=1.44, phi0_offset=0.0, verbose=False,
              device="cpu")
    a = cmp.compare_frequency(str(path), 800e6, highband=True,
                              ray_npz=tmp_path / "ray_a.npz",
                              los_npz=tmp_path / "los_a.npz", **kw)
    b = cmp.compare_frequency(str(path), 800e6, preset=TINY_PRESET,
                              ray_npz=tmp_path / "ray_b.npz",
                              los_npz=tmp_path / "los_b.npz", **kw)
    for x, y in zip(a, b):
        for key in ("emission_cube", "emission_polVI_cube"):
            np.testing.assert_array_equal(x[key], y[key])
    for name in ("ray", "los"):
        with np.load(tmp_path / f"{name}_a.npz") as fa, \
                np.load(tmp_path / f"{name}_b.npz") as fb:
            np.testing.assert_array_equal(fa["emission_cube"],
                                          fb["emission_cube"])


def test_ragged_cube_resamples_as_whole_slabs(scene):
    """prepare_cubes on a 26^3 cube (slabs of 16 and 10 planes) equals the
    reference's scene cubes, and the plain resample in slabs of 16 planes
    equals it in one slab of 26."""
    arrays, mesh, path = scene
    grid = UniformGrid.cube(RAGGED["grid_extent"], RAGGED["grid_n"])
    model = MASModel(path)
    cubes = prepare_cubes(model, grid, 0.0, verbose=False, device="cpu")
    ref = ref_scene.scene_cubes(arrays, mesh, ref_scene.Grid.cube(
        RAGGED["grid_extent"], RAGGED["grid_n"]), 0.0, "cpu", torch.float32)
    for k in ("omega_pe", "ne", "te", "b"):
        assert torch.equal(ref[k], cubes[k]), k
    variables = scene_arrays([model[n] for n in ("rho", "t", "br", "bt",
                                                 "bp")], "cpu")
    axes = [torch.as_tensor(a, dtype=torch.float32) for a in grid.axes()]
    whole = resample.resample_cubes_plain(variables, *axes, 0.0, None,
                                          chunk=26)
    slabs = resample.resample_cubes_plain(variables, *axes, 0.0, None,
                                          chunk=16)
    for a, b in zip(whole, slabs):
        assert torch.equal(torch.nan_to_num(a, nan=-1.0),
                           torch.nan_to_num(b, nan=-1.0))
    assert torch.isnan(whole[0]).any() and torch.isfinite(whole[0]).any()


def test_ragged_cube_traces_and_maps_as_the_reference(scene):
    """On the ragged cube at the 800 MHz preset's geometry, the trace's
    records and the map equal the plain reference's, and some rays start
    outside the disk and leave through the cube's faces."""
    arrays, mesh, path = scene
    grid = UniformGrid.cube(RAGGED["grid_extent"], RAGGED["grid_n"])
    cubes = prepare_cubes(MASModel(path), grid, 0.0, verbose=False,
                          device="cpu")
    _, _, start, kdir = image_ray_starts(8, 1.44, 1.44)
    rays = np.array([0, 7, 20, 27, 36, 63])
    want = trace_rays_segments(
        cubes["omega_pe"], cubes["ne"], cubes["te"], cubes["b"], grid,
        RAGGED["freq_hz"], start[rays], kdir[rays], RAGGED["dt"],
        RAGGED["n_steps"], RAGGED["record_stride"], True, 2.0,
        RAGGED["seg_records"])
    got = ref_map.trace_pixels(arrays, mesh, RAGGED, rays, "cpu")
    assert np.array_equal(got[:, 0:3].numpy().transpose(0, 2, 1),
                          want.r_record, equal_nan=True)
    assert np.array_equal(got[:, 3].numpy(), want.s_record, equal_nan=True)
    assert (want.s_record[-1] == 0).any()
    res = run_ray_tracing_emission(model_path=str(path), verbose=False,
                                   device="cpu", **RAGGED)
    pixels = np.arange(64)
    tb, vi = ref_map.map_pixels(arrays, mesh, RAGGED, pixels, "cpu")
    np.testing.assert_array_equal(tb, res["emission_cube"].reshape(64, 1))
    np.testing.assert_array_equal(vi,
                                  res["emission_polVI_cube"].reshape(64, 1))
    assert tb.max() > 1e5


def compare(path, preset=TINY_PRESET, **kw):
    return cmp.compare_frequency(str(path), 800e6, n_pix=8, x_fov=1.44,
                                 phi0_offset=0.0, preset=preset,
                                 verbose=False, device="cpu", **kw)


def test_timings_hold_both_maps_spans(scene, tmp_path):
    """One recording around both maps: the ray-traced map's stages and
    keys, the LOS chain's spans, "ray" and "los" around each, both
    writes; no counts without torch.profiler."""
    _, _, path = scene
    timings = {}
    compare(path, timings=timings, ray_npz=tmp_path / "r.npz",
            los_npz=tmp_path / "l.npz")
    spans = {"ray", "los", "read", "upload", "rays", "resample", "trace",
             "trace_inputs", "transfer", "finish", "write", *LOS_SPANS}
    assert spans <= set(timings)
    assert not LOS_COUNTS & set(timings) and "fold_counts" not in timings
    assert timings["segments"] == 1 and timings["write_chunks"] >= 1
    los = sum(timings[k] for k in LOS_SPANS)
    assert all(timings[k] > 0 for k in spans)
    assert timings["ray"] > timings["trace"] and timings["los"] >= los


def test_counts_only_under_a_recording_and_the_profiler(scene, monkeypatch):
    """The LOS chain counts only while a recording and torch.profiler are
    both active; then the counts are the chain's own numbers."""
    _, _, path = scene
    taken = []
    count = profiling.count
    monkeypatch.setattr(profiling, "count",
                        lambda *a: (taken.append(a[0]), count(*a)))
    # a trace of 20 steps, to keep the profiled runs short
    short = dict(TINY_PRESET, n_steps=20)
    compare(path, short)
    compare(path, short, timings={})
    with profile(activities=[ProfilerActivity.CPU]):
        compare(path, short)
    assert taken == []
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]):
        compare(path, short, timings=timings)
    assert LOS_COUNTS <= set(timings) and "los_count" in timings
    n = 8 * 8 * TINY_PRESET["n_z"]
    los = resample_mas_los(str(path), n_pix=8, x_range=(-1.44, 1.44),
                           y_range=(-1.44, 1.44), n_z=TINY_PRESET["n_z"],
                           dz0=TINY_PRESET["dz0"], phi0_offset=0.0,
                           verbose=False, device="cpu")
    finite = int((np.isfinite(los["Ne_LOS"]) & np.isfinite(los["Te_LOS"])
                  & np.isfinite(los["B_LOS"])).sum())
    assert timings["los_flagged"] == timings["los_taken"] == finite
    assert 0 < finite <= n


def test_los_spans_are_named_apart_from_the_maps(scene, tmp_path):
    """Every span of the LOS half is named los_..., so that a recording
    around both maps keeps the ray-traced map's own read, upload, write
    and stages; the timings' keys of the ray-traced map are its own."""
    _, _, path = scene
    with profiling.recording("cpu") as rec:
        compare(path, ray_npz=tmp_path / "r.npz", los_npz=tmp_path / "l.npz")

    def under(span, name):
        while span is not None:
            if span.name == name:
                return True
            span = span.parent
        return False

    los = {s.name for s in rec.spans if under(s.parent, "los")}
    ray = {s.name for s in rec.spans if under(s.parent, "ray")}
    assert LOS_SPANS == los
    assert {"read", "upload", "write", "trace"} <= ray
    assert not ray & los
    timings, alone = {}, {}
    compare(path, timings=timings, ray_npz=tmp_path / "r.npz",
            los_npz=tmp_path / "l.npz")
    cmp.run_ray_tracing_emission(
        model_path=str(path), config=cmp.RayEmissionConfig(
            n_pix=8, x_fov=1.44, freq_hz=800e6, **{
                k: v for k, v in TINY_PRESET.items()
                if k not in ("dz0", "n_z")}),
        out_path=tmp_path / "r2.npz", verbose=False, device="cpu",
        timings=alone)
    assert set(alone) <= set(timings)
    assert set(timings) - set(alone) == LOS_SPANS | {"ray", "los"}


def test_counters_sum_into_nested_recordings():
    with profiling.recording("cpu") as outer:
        profiling.count("a", 2)
        with profiling.recording("cpu") as inner:
            profiling.count("a", torch.tensor(3))
            profiling.count("b", torch.tensor([4]))
    profiling.count("a", 100)              # no recording: nothing
    assert outer.counters() == {"a": 5, "b": 4}
    assert inner.counters() == {"a": 3, "b": 4}
    assert not profiling.counting()
    with profiling.recording("cpu"):
        assert not profiling.counting()
        with profile(activities=[ProfilerActivity.CPU]):
            assert profiling.counting()
