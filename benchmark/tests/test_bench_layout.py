"""BENCHMARK.json against the contract's shape, and every entry against
the files the harness finds it by."""

import json
import re
import shutil

import pytest

from benchmark.harness import BENCH, ROOT, Cell, read_json, reader, run_cell
from benchmark.tests.tiny import tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = read_json(ROOT / "BENCHMARK.json")


def test_top_level_keys_and_paths():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert NAME.match(entry["name"])
    path = ROOT / entry["file"]
    assert path.parent == BENCH / "configs" and path.is_file()
    config = read_json(path)
    assert config["name"] == entry["name"]
    assert config["dtype"] == "float32" and config["chips"] == 1
    assert sorted(config["reduced"]) == sorted(entry["reduced"])
    assert 1 <= len(entry["source"]) <= 200 and 1 <= len(entry["why"]) <= 200


@pytest.mark.parametrize("entry", BENCHMARK["workloads"],
                         ids=lambda w: w["name"])
def test_cell_resolves(entry):
    assert NAME.match(entry["name"]) and entry["chips"] == 1
    assert len(entry["why"]) <= 200
    cell = Cell(entry["name"])
    assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.end_to_end + cell.per_layer:
        assert callable(reader(m["name"]))
    for number in cell.traffic["check"]["limits"]:
        assert NAME.match(number)


@pytest.mark.parametrize("metric", BENCHMARK["end_to_end"]
                         + BENCHMARK["per_layer"], ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    cells = {w["name"] for w in BENCHMARK["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"]: m for m in BENCHMARK["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert metric["layer"] and "\n" not in metric["layer"]


def test_a_cell_added_as_files_runs_without_editing(tmp_path):
    """A new cell is an entry of BENCHMARK.json with its traffic file:
    the harness finds and runs it with no file of the benchmark edited."""
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({
        "name": "trace_coarse", "config": "canonical_75mhz",
        "traffic": "trace_coarse", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "trace_canonical" in m.get("workloads", []):
            m["workloads"].append("trace_coarse")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(BENCH / "configs", tmp_path / "benchmark" / "configs")
    traffic = read_json(BENCH / "traffic" / "trace_256.json")
    traffic["map"] = {"n_pix": 6}
    (tmp_path / "benchmark" / "traffic").mkdir()
    (tmp_path / "benchmark" / "traffic" / "trace_coarse.json").write_text(
        json.dumps(traffic))
    cell = tiny_cell("trace_coarse", tmp_path / "BENCHMARK.json")
    cell.traffic["map"]["n_pix"] = 6
    result = run_cell(cell, 5, 0.01, 0, "cpu", tmp_path / "work")
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "ray_steps_per_s"}
    assert list(result)[-1] == "check"
