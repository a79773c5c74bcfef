"""A run with the timed path broken underneath reads `correct` false:
the harness's look for a card skipped, everything else as in a run, at a
tiny size on the CPU. One chip has no exchange between chips to leave
out; the other faults each cell can have are planted in the program."""

import pytest
import torch

import raytracinggrff_tpu_torch.ops.transfer_fold as transfer_fold
import raytracinggrff_tpu_torch.pipeline as pipeline
import raytracinggrff_tpu_torch.tracer_segments as tracer_segments
from benchmark.harness import ROOT, read_json, run_cell
from benchmark.tests.tiny import tiny_cell, tiny_sweep_presets

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]
segment = tracer_segments.trace_segment
fold = transfer_fold.fold_records
tb_from_sfu = pipeline.tb_from_sfu


def state_unchanged(monkeypatch):
    """Each trace segment hands back the state it was given."""
    def broken(tcube, scube, state, *a, **k):
        return state, segment(tcube, scube, state, *a, **k)[1]
    monkeypatch.setattr(tracer_segments, "trace_segment", broken)


def carry_unchanged(monkeypatch):
    """Each record fold hands back the carry it was given."""
    def broken(recs, carry, prev, *a, **k):
        return tuple(carry), fold(recs, carry, prev, *a, **k)[1]
    monkeypatch.setattr(transfer_fold, "fold_records", broken)


def half_the_rays(monkeypatch):
    """Each segment traces the first half of the rays; the rest keep
    their state and get zero records."""
    def broken(tcube, scube, state, *a, **k):
        half = state.shape[1] // 2
        s, r = segment(tcube, scube, state[:, :half].contiguous(), *a, **k)
        out = torch.cat([s, state[:, half:]], dim=1)
        rec = torch.zeros(r.shape[:2] + (state.shape[1],))
        rec[:, :, :half] = r
        return out, rec
    monkeypatch.setattr(tracer_segments, "trace_segment", broken)


def records_altered(monkeypatch):
    """Each segment's x positions move by 0.05 R_sun, about a cell of the
    canonical cube, where they are produced."""
    def broken(*a, **k):
        s, r = segment(*a, **k)
        r = r.clone()
        r[:, 0] += 0.05
        return s, r
    monkeypatch.setattr(tracer_segments, "trace_segment", broken)


def tb_altered(monkeypatch):
    """T_b is 2% high where it is produced."""
    monkeypatch.setattr(pipeline, "tb_from_sfu",
                        lambda *a: tb_from_sfu(*a) * 1.02)


def flux_not_finite(monkeypatch):
    """One ray's flux is NaN where the fold produces it, so its map's V/I
    is not finite."""
    def broken(*a, **k):
        carry, prev = fold(*a, **k)
        carry = tuple(c.clone() for c in carry)
        carry[0][0] = float("nan")
        return carry, prev
    monkeypatch.setattr(transfer_fold, "fold_records", broken)


TRACE_FAULTS = [state_unchanged, half_the_rays, records_altered]
MAP_FAULTS = [state_unchanged, carry_unchanged, half_the_rays, tb_altered,
              flux_not_finite]
CASES = [(cell, fault) for cell in CELLS
         for fault in (TRACE_FAULTS if cell.startswith("trace")
                       else MAP_FAULTS)]


@pytest.mark.parametrize("name, fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_reads_incorrect(name, fault, tmp_path, monkeypatch):
    cell = tiny_cell(name)
    with tiny_sweep_presets(monkeypatch), torch.inference_mode():
        fault(monkeypatch)
        result = run_cell(cell, 13, 0.01, 0, "cpu", tmp_path)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_reads_correct(name, tmp_path, monkeypatch):
    cell = tiny_cell(name)
    with tiny_sweep_presets(monkeypatch), torch.inference_mode():
        result = run_cell(cell, 13, 0.01, 0, "cpu", tmp_path)
    assert result["correct"] is True, result["check"]
    assert all(c["value"] == 0 for c in result["check"].values())
