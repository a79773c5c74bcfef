"""The port's benchmark harness (raytracinggrff_tpu_torch/harness.py, run
as bench_torch.py) against the root bench.py: the same cube and pipeline
config, bench.py's JSON keys less vs_baseline, and no jax on its path. The
runs are on the CPU at a tiny size (4^2 rays x 40 steps x 16^3)."""

import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracinggrff_tpu.pipeline import RayEmissionConfig as JaxConfig
from raytracinggrff_tpu_torch import harness
from raytracinggrff_tpu_torch.pipeline import config_from_jax

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
TINY = ["--n-pix", "4", "--n-steps", "40", "--grid-n", "16", "--repeat",
        "1", "--device", "cpu"]
BENCH_KEYS = {"metric", "value", "unit", "times_s", "warmup_s", "workload"}
# run a script with jax and the JAX package unimportable
NO_JAX = ("import runpy, sys\n"
          "sys.modules['jax'] = None\n"
          "sys.modules['raytracinggrff_tpu'] = None\n"
          "import raytracinggrff_tpu_torch.harness\n"
          "sys.argv = ['bench_torch.py'] + sys.argv[1:]\n"
          "runpy.run_path('bench_torch.py', run_name='__main__')\n")


def _bench_py():
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  ROOT / "bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_without_jax(args):
    return subprocess.run([sys.executable, "-c", NO_JAX, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)


@pytest.mark.parametrize("mode", ["trace", "pipeline"])
def test_bench_torch_prints_one_line_without_jax(mode):
    """bench_torch.py at a tiny size on the CPU, with jax blocked, prints
    one JSON line with bench.py's keys less vs_baseline; the trace rate is
    n_pix^2 x steps_run / median and the pipeline's value median / nfreq."""
    args = TINY + (["--pipeline"] if mode == "pipeline" else [])
    proc = _run_without_jax(args)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert set(out) == BENCH_KEYS
    w = out["workload"]
    assert w["steps_run"] == 31 and w["device"] == "cpu"
    assert "gpu" not in w and "power_limit" not in w
    median = float(np.median(out["times_s"]))
    assert len(out["times_s"]) == 1 and out["warmup_s"] > 0
    if mode == "trace":
        assert out["metric"] == "ray-steps/sec/chip"
        assert out["unit"] == "ray-steps/s"
        assert out["value"] == pytest.approx(16 * 31 / median, rel=1e-12)
        assert "nfreq" not in w
    else:
        assert out["metric"] == "pipeline-s-per-frequency"
        assert out["unit"] == "s/freq/chip"
        assert w["nfreq"] == 3
        assert out["value"] == pytest.approx(median / 3, rel=1e-12)
    assert "repeat 0:" in proc.stderr and "warmup" in proc.stderr


def test_bench_torch_help_without_jax():
    proc = _run_without_jax(["--help"])
    assert proc.returncode == 0, proc.stderr
    assert "--pipeline" in proc.stdout and "--device" in proc.stdout
    assert "--tracer" not in proc.stdout and "--rpt" not in proc.stdout


def test_sources_import_no_jax():
    jax_import = re.compile(
        r"^\s*(import|from)\s+(jax\b|raytracinggrff_tpu\b(?!_torch))",
        re.MULTILINE)
    for path in (ROOT / "bench_torch.py",
                 ROOT / "raytracinggrff_tpu_torch" / "harness.py"):
        assert not jax_import.search(path.read_text()), path


@pytest.mark.parametrize("grid_n", [16, 33, 128])
def test_make_cube_equals_bench(grid_n):
    grid, wpe, ne = harness.make_cube(grid_n, 75e6)
    jgrid, jwpe, jne = _bench_py().make_cube(grid_n, 75e6)
    assert dataclasses.asdict(grid) == dataclasses.asdict(jgrid)
    assert wpe.dtype == ne.dtype == np.float32
    np.testing.assert_array_equal(wpe, jwpe)
    np.testing.assert_array_equal(ne, jne)


def test_make_rays_equals_bench():
    for a, b in zip(harness.make_rays(16), _bench_py().make_rays(16)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", [[], ["--n-pix", "64", "--n-steps", "900",
                                       "--grid-n", "96", "--record-stride",
                                       "5", "--freq", "150e6", "--nfreq", "2",
                                       "--seg-records", "16"]])
def test_pipeline_config_equals_bench(argv):
    """harness.pipeline_config equals config_from_jax of the config that
    bench.py:127-133 builds from the same flags (its TPU knobs at their
    defaults)."""
    args = harness.build_parser().parse_args(argv)
    jcfg = JaxConfig(
        n_pix=args.n_pix, freq_hz=args.freq, grid_n=args.grid_n,
        grid_extent=3.0, z_observer=3.0, dt=6e-3, n_steps=args.n_steps,
        record_stride=args.record_stride, nfreq=args.nfreq,
        freq0=args.freq, freq_log_step=0.05, s_input_on=True,
        tracer_backend="pallas", rays_per_tile=128,
        seg_records=args.seg_records, tile_factor=4)
    assert harness.pipeline_config(args) == config_from_jax(jcfg)


def test_defaults_are_the_canonical_workload():
    args = harness.build_parser().parse_args([])
    assert (args.n_pix, args.n_steps, args.grid_n, args.record_stride,
            args.freq, args.repeat, args.nfreq, args.seg_records) == (
        256, 5000, 128, 10, 75e6, 3, 3, 64)
    assert args.device == "cuda" and not args.no_crosssections
    assert harness.steps_run(5000, 10) == 4991


def test_cuda_without_a_card_raises():
    """No fallback: --device cuda on a machine without a card raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        harness.main(TINY[:-1] + ["cuda"])


def test_pipeline_refuses_no_crosssections(capsys):
    with pytest.raises(SystemExit):
        harness.main(TINY + ["--pipeline", "--no-crosssections"])
    assert "--no-crosssections" in capsys.readouterr().err


def test_in_process_run_returns_its_line(capsys):
    """main returns the dict it prints; without cross-sections the trace
    runs and its workload says so."""
    out = harness.main(TINY + ["--no-crosssections"])
    assert json.loads(capsys.readouterr().out) == out
    assert out["workload"]["crosssections"] is False
