"""The plain reference of the gyroresonance map
(benchmark/reference/gyro.py) against the port's plain path on the CPU, at
a small size of the map_gyro cell: b0 50 G, mechanism 7, theta(B, k) per
record. Also the record fold's counts (timings["fold_counts"]): taken
only while torch.profiler records, and equal to a direct count of the
records the fold was given."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from benchmark.gen.mas import mas_arrays, write_mas_dir  # noqa: E402
from benchmark.reference import gyro  # noqa: E402
from raytracinggrff_tpu_torch.constants import R_SUN_CM  # noqa: E402
from raytracinggrff_tpu_torch.grids import UniformGrid  # noqa: E402
from raytracinggrff_tpu_torch.mas.model import MASModel  # noqa: E402
from raytracinggrff_tpu_torch.ops import transfer_fold  # noqa: E402
from raytracinggrff_tpu_torch.ops.los_scans import record_step  # noqa: E402
from raytracinggrff_tpu_torch.pipeline import (  # noqa: E402
    image_ray_starts, prepare_cubes, run_ray_tracing_emission)
from raytracinggrff_tpu_torch.tracer_segments import (  # noqa: E402
    segment_plan, trace_rays_segments)

SCENE = dict(nphi=16, ntheta=12, nr=14, r_max=6.0, b0_gauss=50.0,
             timestep=2, modulation_amplitude=[0.2, 0.4],
             modulation_phase_rad=[0.0, 6.283185307179586])
RUN = dict(n_pix=12, x_fov=1.44, freq_hz=75e6, grid_n=32, grid_extent=3.0,
           z_observer=3.0, dt=3e-2, n_steps=500, record_stride=10,
           s_input_on=True, nfreq=11, freq0=75e6, freq_log_step=0.01,
           perturb_ratio=2.0, phi0_offset=0.0, mechanism=7, theta_deg=90.0,
           theta_mode="los", gaunt="dulk", s_mode="cumulative",
           seg_records=16)
# The port sums the harmonics s = 2..30 in float32 (the fold kernel in
# order, torch's sum over the harmonic axis in its own); 2e-4 relative is
# the repository's bar for the gyroresonance fold against its plain
# version (tests/test_torch_transfer_fold.py), and holds here, where both
# sides are plain torch
GR_RTOL = 2e-4
# V/I is a difference of the mode fluxes over their sum: twice the bar
VI_ATOL = 2 * GR_RTOL


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    arrays, mesh = mas_arrays(SCENE, 2 ** 33 + 17)
    path = write_mas_dir(tmp_path_factory.mktemp("gyro") / "corona", arrays,
                         mesh, SCENE["timestep"])
    grid = UniformGrid.cube(RUN["grid_extent"], RUN["grid_n"])
    cubes = prepare_cubes(MASModel(path), grid, RUN["phi0_offset"],
                          verbose=False, keep_bvec=True, device="cpu")
    return arrays, mesh, path, grid, cubes


def port_records(cubes, grid, rays):
    _, _, start, kdir = image_ray_starts(RUN["n_pix"], RUN["x_fov"],
                                         RUN["z_observer"])
    out = trace_rays_segments(
        cubes["omega_pe"], cubes["ne"], cubes["te"], cubes["b"], grid,
        RUN["freq_hz"], start[rays], kdir[rays], RUN["dt"], RUN["n_steps"],
        RUN["record_stride"], True, RUN["perturb_ratio"], RUN["seg_records"],
        bvec=cubes["bvec"])
    return out, start[rays]


def record_block(out):
    """The (n_records, 8, n_rays) record block of a SegmentTraceResult."""
    return torch.as_tensor(np.concatenate(
        [out.r_record.transpose(0, 2, 1), out.s_record[:, None],
         out.ne[:, None], out.te[:, None], out.b[:, None],
         out.cos_theta[:, None]], axis=1)).contiguous()


def exit_records(recs):
    """(record, ray) pairs at which a ray leaving the cube froze: position
    finite and S > 0, row 7 NaN."""
    pos_ok = torch.isfinite(recs[:, 0:3]).all(dim=1)
    return (pos_ok & (recs[:, 3] > 0) & torch.isnan(recs[:, 7])).nonzero()


def test_scene_cubes_equal_prepare_cubes(scene):
    arrays, mesh, _, grid, cubes = scene
    ref = gyro.scene_cubes(arrays, mesh,
                           gyro.Grid.cube(RUN["grid_extent"], RUN["grid_n"]),
                           RUN["phi0_offset"], "cpu", torch.float32)
    for k in ("omega_pe", "ne", "te", "b"):
        assert torch.equal(ref[k], cubes[k]), k
    for i in range(3):
        assert torch.equal(ref["bvec"][i], cubes["bvec"][i]), i
    assert float(cubes["bvec"][0].abs().max()) > 1.0


def test_records_with_row_7_equal_the_port_trace(scene):
    """Every row, 7 included, equals the port's plain 8-channel trace, NaN
    where it has NaN; some rays leave the cube and have the exit record
    whose angle is NaN."""
    arrays, mesh, _, grid, cubes = scene
    rays = np.arange(RUN["n_pix"] ** 2)
    want, start = port_records(cubes, grid, rays)
    _, _, _, kdir = image_ray_starts(RUN["n_pix"], RUN["x_fov"],
                                     RUN["z_observer"])
    ref_cubes = gyro.scene_cubes(arrays, mesh, gyro.Grid.cube(
        RUN["grid_extent"], RUN["grid_n"]), RUN["phi0_offset"], "cpu",
        torch.float32)
    got = gyro.trace_records(ref_cubes, gyro.Grid.cube(
        RUN["grid_extent"], RUN["grid_n"]), RUN["freq_hz"], start,
        kdir[rays], RUN["dt"], RUN["n_steps"], RUN["record_stride"],
        RUN["perturb_ratio"])
    np.testing.assert_array_equal(got[:, 0:3].numpy().transpose(0, 2, 1),
                                  want.r_record)
    for row, name in ((3, "s_record"), (4, "ne"), (5, "te"), (6, "b"),
                      (7, "cos_theta")):
        np.testing.assert_array_equal(got[:, row].numpy(),
                                      getattr(want, name), err_msg=name)
    assert len(exit_records(got)) > 0
    assert np.nanmax(np.abs(want.cos_theta)) > 0.5


@pytest.mark.parametrize("nfreq", [3, 11])
def test_map_matches_the_port(scene, nfreq):
    """T_b and V/I of the reference's pixels, among them rays that leave
    the cube with the NaN-angle exit record, against the port's map."""
    arrays, mesh, path, grid, cubes = scene
    run = dict(RUN, nfreq=nfreq)
    res = run_ray_tracing_emission(model_path=str(path), verbose=False,
                                   device="cpu", **run)
    n = RUN["n_pix"] ** 2
    recs, _ = port_records(cubes, grid, np.arange(n))
    rec = record_block(recs)
    leaving = np.unique(exit_records(rec)[:, 1].numpy())
    pixels = np.unique(np.concatenate([leaving[:6], [0, 17, 66, 78, 143]]))
    tb, vi = gyro.map_pixels(arrays, mesh, run, pixels, "cpu")
    want_tb = res["emission_cube"].reshape(n, nfreq)[pixels]
    want_vi = res["emission_polVI_cube"].reshape(n, nfreq)[pixels]
    assert len(leaving) > 0 and (want_tb > 1e4).mean() > 0.5
    np.testing.assert_allclose(tb, want_tb, rtol=GR_RTOL)
    np.testing.assert_allclose(vi, want_vi, rtol=0, atol=VI_ATOL)
    mech5 = gyro.map_pixels(arrays, mesh, dict(run, mechanism=5), pixels,
                            "cpu")[0]
    assert (np.abs(mech5 / want_tb - 1.0) > 0.01).any()


def test_fluxes_match_the_port_fold(scene):
    """The reference's record fold against the port's plain fold on the
    port's records, in one segment."""
    _, _, _, grid, cubes = scene
    rays = np.arange(0, RUN["n_pix"] ** 2, 3)
    recs, start = port_records(cubes, grid, rays)
    rec = record_block(recs)
    freqs = torch.as_tensor(75e6 * 10.0 ** (0.01 * np.arange(11)),
                            dtype=torch.float32)
    area = ((2 * RUN["x_fov"]) / RUN["n_pix"] * R_SUN_CM) ** 2
    fo, fx = gyro.fold_records(rec, start, freqs, area, 7, True,
                               torch.float32)
    z = torch.zeros((len(rays), 11))
    carry, _ = transfer_fold.fold_records(
        rec, (z, z, z, z), torch.as_tensor(start), freqs, area, 90.0, 7,
        s_on=True, theta_los=True)
    assert float(carry[0].max()) > 0
    np.testing.assert_allclose(fo.numpy(), carry[0].numpy(), rtol=GR_RTOL)
    np.testing.assert_allclose(fx.numpy(), carry[1].numpy(), rtol=GR_RTOL)


def folds_seen(monkeypatch):
    """Wrap transfer_fold.fold_records and fold_counts: the records and
    last valid positions of each fold, and the number of counts, in a
    dict."""
    seen = {"folds": [], "counts": 0}
    fold, count = transfer_fold.fold_records, transfer_fold.fold_counts

    def spy_fold(recs, carry, prev, *a, **k):
        seen["folds"].append((recs.clone(), prev.clone()))
        return fold(recs, carry, prev, *a, **k)

    def spy_count(*a, **k):
        seen["counts"] += 1
        return count(*a, **k)

    monkeypatch.setattr(transfer_fold, "fold_records", spy_fold)
    monkeypatch.setattr(transfer_fold, "fold_counts", spy_count)
    return seen


def test_fold_counts_equal_a_direct_count(scene, monkeypatch):
    """Traced, each segment's [stepped from, taken] equals a count of the
    records its fold was given by chip_smoke.fold_records_bound's rule,
    the counting has a span of its own ("count"), and the map equals the
    untraced one."""
    _, _, path, _, _ = scene
    seen = folds_seen(monkeypatch)
    timings = {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        traced = run_ray_tracing_emission(model_path=str(path),
                                          verbose=False, device="cpu",
                                          timings=timings, **RUN)
    plan, _ = segment_plan(RUN["n_steps"], RUN["record_stride"],
                           RUN["seg_records"])
    counts = timings["fold_counts"]
    assert len(counts) == len(seen["folds"]) == len(plan) == seen["counts"]
    assert timings["count"] >= 0.0          # the counts' span of their own
    for (recs, prev), (stepped, taken) in zip(seen["folds"], counts):
        want_taken = chip_smoke.fold_records_bound(
            recs, prev, RUN["nfreq"], RUN["mechanism"], theta_los=True)[2]
        want_stepped = 0
        for rec in recs:
            valid, _, prev = record_step(rec[0:3].T, rec[3], prev,
                                         np.float32(R_SUN_CM),
                                         torch.isfinite(rec[7]))
            want_stepped += int(valid.sum())
        assert (stepped, taken) == (want_stepped, want_taken)
    assert sum(t for _, t in counts) > 0
    untraced = run_ray_tracing_emission(model_path=str(path), verbose=False,
                                        device="cpu", **RUN)
    for k in ("emission_cube", "emission_polVI_cube"):
        np.testing.assert_array_equal(traced[k], untraced[k])


def test_untraced_map_counts_nothing(scene, monkeypatch):
    """Without torch.profiler, or without a timings dict, nothing is
    counted and the timings hold no counts."""
    _, _, path, _, _ = scene
    run = dict(RUN, n_pix=6, n_steps=200)
    seen = folds_seen(monkeypatch)
    timings = {}
    run_ray_tracing_emission(model_path=str(path), verbose=False,
                             device="cpu", timings=timings, **run)
    assert "fold_counts" not in timings and "write_chunks" not in timings
    assert "count" not in timings
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        run_ray_tracing_emission(model_path=str(path), verbose=False,
                                 device="cpu", **run)
    assert len(seen["folds"]) == 2 * timings["segments"]
    assert seen["counts"] == 0


def test_fold_counts_arguments_are_checked():
    rec = torch.zeros((4, 8, 3))
    rec[:, 3] = 1.0                    # S > 0, positions all at the start
    prev = torch.zeros((3, 3))
    with pytest.raises(TypeError):
        transfer_fold.fold_counts(rec, prev, torch.zeros(2))
    with pytest.raises(ValueError):
        transfer_fold.fold_counts(rec, prev, torch.zeros(3, dtype=int))
    counts = torch.tensor([5, 7])
    transfer_fold.fold_counts(rec, prev, counts)
    # every record is valid; none moves from the last valid position
    assert counts.tolist() == [5 + 12, 7]
    rec[2, 0] = 0.5
    rec[3, 7] = float("nan")
    assert transfer_fold.fold_counts_plain(rec, prev).tolist() == [12, 6]
    assert transfer_fold.fold_counts_plain(rec, prev, True).tolist() == [9, 3]
