"""The control fails: the plain reference computed in bfloat16, the
precision below the float32 the configurations state, put in the
program's place, misses each cell's limits at a size a test can hold.
On the card, benchmark/calibrate.py reads the control at each cell's own
size; PERF.md keeps its readings."""

import pytest
import torch

from benchmark.calibrate import CONTROL_DTYPE, readings
from benchmark.harness import read_json, ROOT
from benchmark.tests.tiny import tiny_cell, tiny_sweep_presets

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_misses_a_limit(name, tmp_path, monkeypatch):
    assert CONTROL_DTYPE == torch.bfloat16
    cell = tiny_cell(name)
    limits = cell.traffic["check"]["limits"]
    with tiny_sweep_presets(monkeypatch), torch.inference_mode():
        out = readings(cell, 11, 0.01, True, torch.device("cpu"), tmp_path)
    assert all(v <= limits.get(k, 0) for k, v in out["program"].items())
    assert any(v > limits[k] for k, v in out["control"].items()), out
