"""A short run of each cell on a card, as the driver runs it; skipped
without one. On the card:

    python -m pytest benchmark/tests/test_bench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from benchmark.harness import ROOT, read_json

CELLS = [w["name"] for w in read_json(ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483713", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "check"


def test_no_card_means_no_result(monkeypatch, capsys):
    """Without a card the harness exits nonzero and prints no result."""
    import torch
    from benchmark.harness import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"], 0.0)
    assert rc != 0 and capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the run exits nonzero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
