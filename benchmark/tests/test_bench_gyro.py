"""The map_gyro cell: its reference and yardstick load nothing of the
program, faults planted in the program's gyroresonance path read
`correct` false, and the record fold's roofline reads None without the
program's counts and a share in (0, 100] with them. At a tiny size on the
CPU, where the program runs its plain versions."""

import numpy as np
import pytest
import torch

import chip_smoke
import raytracinggrff_tpu_torch.ops.transfer_fold as transfer_fold
import raytracinggrff_tpu_torch.pipeline as pipeline
from benchmark.drivers.common import map_settings
from benchmark.harness import Run, reader, run_cell
from benchmark.tests.test_bench_imports import top_level_modules
from benchmark.tests.tiny import tiny_cell
from benchmark.yardstick import fold_roofline
from raytracinggrff_tpu_torch.constants import R_SUN_CM
from raytracinggrff_tpu_torch.ops.los_scans import record_step
from raytracinggrff_tpu_torch.tracer_segments import segment_plan

CELL = "map_gyro"
fold = transfer_fold.fold_records
tb_from_sfu = pipeline.tb_from_sfu


def test_reference_and_yardstick_load_nothing_of_the_program():
    loaded = top_level_modules(["benchmark.reference.gyro",
                                "benchmark.yardstick.fold_roofline"])
    assert not loaded & {"raytracinggrff_tpu_torch", "raytracinggrff_tpu",
                         "jax", "jaxlib"}
    loaded = top_level_modules(["benchmark.drivers.map_gyro"])
    assert "raytracinggrff_tpu_torch" in loaded
    assert not loaded & {"raytracinggrff_tpu", "jax", "jaxlib"}


def theta_fixed(monkeypatch):
    """The fold ignores row 7 and takes theta = 90 deg."""
    monkeypatch.setattr(transfer_fold, "fold_records",
                        lambda *a, **k: fold(*a, **dict(k, theta_los=False)))


def harmonics_to_two(monkeypatch):
    """The fold sums the second harmonic only."""
    monkeypatch.setattr(transfer_fold, "fold_records",
                        lambda *a, **k: fold(*a, **dict(k, s_max=2)))


def mechanism_five(monkeypatch):
    """The fold runs free-free with neutrals, without gyroresonance."""
    def broken(recs, carry, prev, freqs, area, theta_deg, mechanism, **k):
        return fold(recs, carry, prev, freqs, area, theta_deg, 5, **k)
    monkeypatch.setattr(transfer_fold, "fold_records", broken)


def tb_high(monkeypatch):
    """T_b is 2% high where it is produced."""
    monkeypatch.setattr(pipeline, "tb_from_sfu",
                        lambda *a: tb_from_sfu(*a) * 1.02)


@pytest.mark.parametrize("fault", [theta_fixed, harmonics_to_two,
                                   mechanism_five, tb_high],
                         ids=lambda f: f.__name__)
def test_gyro_fault_reads_incorrect(fault, tmp_path, monkeypatch):
    cell = tiny_cell(CELL)
    with torch.inference_mode():
        fault(monkeypatch)
        result = run_cell(cell, 13, 0.01, 0, "cpu", tmp_path)
    assert result["correct"] is False, result["check"]


def test_fold_roofline_reads_none_without_counts():
    """The parent's program gives no fold_counts: the reader returns
    None, whatever the device trace holds."""
    run = Run(tiny_cell(CELL), 1.0, 1, "cpu")
    assert reader("fold_roofline.map")(run) is None
    run.units = [{"wall": 1.0, "nfreq": 11, "timings": {"transfer": 0.1}}]
    run.kernel_us = {"void (anonymous namespace)::fold_records_kernel<8>":
                     5e4}
    assert reader("fold_roofline.map")(run) is None


def test_fold_roofline_on_a_traced_run(tmp_path):
    """A traced run on the CPU carries the program's counts; with the
    fold's device time taken as the CPU's transfer time, the share lies in
    (0, 100]; without a fold kernel in the trace it reads None."""
    cell = tiny_cell(CELL)
    with torch.inference_mode():
        result = run_cell(cell, 21, 0.01, 1, "cpu", tmp_path)
    assert result["correct"], result["check"]
    assert "fold_roofline.map" not in result["metrics"]
    run = Run(cell, 1.0, 1, "cpu")
    run.units = [{"wall": 1.0, "nfreq": 11,
                  "timings": {"transfer": 0.05, "fold_counts": [
                      [500, 400]] * len(segment_plan(200, 10, 8)[0])}}]
    run.kernel_us = {"void (anonymous namespace)::fold_records_kernel<8>":
                     5e4, "other_kernel": 1e3}
    share = reader("fold_roofline.map")(run)
    assert 0.0 < share <= 100.0
    settings = map_settings(cell)
    plan = fold_roofline.segment_records(200, 10, 8)
    want = sum(fold_roofline.fold_bound_ms(500, 400, rps, 64, 11, 7, "dulk",
                                           True, True)[0] for rps in plan)
    assert settings["n_pix"] == 8 and settings["seg_records"] == 8
    assert share == pytest.approx(100.0 * want / 50.0)


def test_segment_records_are_the_program_plan():
    for args in ((5000, 10, 64), (650, 10, 64), (201, 10, 7), (200, 10, 8)):
        assert fold_roofline.segment_records(*args) == [
            rps for _, rps in segment_plan(*args)[0]]


def test_fold_flops_match_chip_smoke():
    for nf, mech, gaunt in ((3, 5, "dulk"), (11, 7, "dulk"), (1, 2, "exact"),
                            (4, 1, "exact")):
        assert fold_roofline.fold_flops(nf, mech, gaunt) == \
            chip_smoke.fold_flops(nf, mech, gaunt)
    for name in ("FOLD_FLOPS_RECORD", "FOLD_FLOPS_COMMON", "FOLD_FLOPS_FF",
                 "FOLD_FLOPS_NEUTRALS", "FOLD_FLOPS_GR",
                 "FOLD_FLOPS_HARMONIC"):
        assert getattr(fold_roofline, name) == getattr(chip_smoke, name)


@pytest.mark.parametrize("theta_los, mechanism, nf", [(True, 7, 11),
                                                      (False, 5, 3)])
def test_fold_bound_matches_chip_smoke(theta_los, mechanism, nf):
    """On records with rays frozen and leaving part way, the bound from
    the counts is chip_smoke's bound from the records."""
    g = torch.Generator().manual_seed(5)
    n_rays, rps = 2048, 64
    rec = torch.rand((rps, 8, n_rays), generator=g) * 2.0 - 1.0
    exit_at = torch.randint(0, rps + 8, (n_rays,), generator=g)
    gone = torch.arange(rps)[:, None] >= exit_at[None]
    rec[:, 3] = torch.where(gone, 0.0, 1.0)
    rec[:, 7] = torch.where(torch.arange(rps)[:, None] == exit_at[None],
                            float("nan"), rec[:, 7])
    rec[5:9, 0:3, :7] = rec[4, 0:3, :7][None]  # rays that do not move
    rec[10, 4, 7:20] = float("nan")            # fields not finite
    prev = torch.rand((n_rays, 3), generator=g)
    want = chip_smoke.fold_records_bound(rec, prev, nf, mechanism,
                                         theta_los=theta_los)
    stepped = taken = 0
    p = prev
    for r in rec:
        valid, ds, p = record_step(r[0:3].T, r[3], p, np.float32(R_SUN_CM),
                                   torch.isfinite(r[7]) if theta_los
                                   else None)
        stepped += int(valid.sum())
        taken += int((valid & torch.isfinite(r[4:7]).all(dim=0)
                      & torch.isfinite(ds) & (ds > 0)).sum())
    assert taken == want[2] and 0 < taken < stepped
    got = fold_roofline.fold_bound_ms(stepped, taken, rps, n_rays, nf,
                                      mechanism, "dulk", True, theta_los)
    assert got == want[:2]
