"""The benchmark harness: one cell, one run, one JSON line.

A cell is an entry of BENCHMARK.json's "workloads": a configuration
(its file, named in "configs") under a traffic mix
(benchmark/traffic/<traffic>.json). The traffic file names the driver
(benchmark/drivers/<driver>.py) that makes one unit of work, and the
limits of the comparison that decides `correct`. Each metric of
BENCHMARK.json has its reader, benchmark/metrics/<metric>.py, whose
read(run) returns the metric's value or None. Nothing here is specific to
a cell: a new cell is a new entry with its data files, and a new kind of
unit a new driver.

A run: the driver's set-up (the seeded MAS model written, the program's
set-up, one warm-up unit), then units back to back until --seconds have
passed since the first one started (the window ends with the last unit
that started inside it), then, with the peak device memory read and the
program's state dropped, the driver's comparison against the plain
reference. With --trace 1 the window runs under torch.profiler and the
line carries the per-layer metrics, the device's busy seconds and a
breakdown; with --trace 0 it carries the end-to-end metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinggrff_tpu")


def read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix,
    driver and metrics."""

    def __init__(self, name, bench_path=None):
        bench_path = Path(bench_path or ROOT / "BENCHMARK.json")
        root = bench_path.parent
        bench = read_json(bench_path)
        entry = {w["name"]: w for w in bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        configs = {c["name"]: c for c in bench["configs"]}
        self.name = name
        self.chips = int(entry["chips"])
        self.config = read_json(root / configs[entry["config"]]["file"])
        self.traffic = read_json(root / BENCH.name / "traffic"
                                 / f"{entry['traffic']}.json")
        self.driver = importlib.import_module(
            f"benchmark.drivers.{self.traffic['driver']}")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]


def reader(metric):
    """The read() of benchmark/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What a run collects for the metric readers: the completed units
    (dicts from the driver, each with its "wall"), the window, the set-up
    time and, when traced, the device's busy time and kernel times."""

    def __init__(self, cell, seconds, trace, device):
        self.cell, self.seconds = cell, seconds
        self.trace, self.device = bool(trace), torch.device(device)
        self.units, self.attempted, self.failed = [], 0, 0
        self.setup_s = self.window_s = None
        self.busy_s = None
        self.kernel_us = {}         # device op name -> microseconds
        self.idle_by_host = {}      # host label -> idle seconds
        self.extra = {}             # the driver's own readings


def _profile_events(prof):
    """(device ops [(name, start_us, end_us)], host ops [same]) of a
    finished profiler; the device shadows of the host's spans are left
    out."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        item = (e.name(), s, s + e.duration_ns() / 1e3)
        if e.device_type() != DeviceType.CUDA:
            host.append(item)
        elif not e.is_user_annotation():
            dev.append(item)
    return dev, host


def _read_trace(run, prof):
    """Fill the run's device readings from the profiler."""
    from .yardstick.device_trace import busy_seconds, idle_gaps, label_gaps
    dev, host = _profile_events(prof)
    spans = [(s, e) for name, s, e in host if name == "bench.window"]
    if not spans:
        return
    lo, hi = spans[0]
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
              if e > lo and s < hi]
    spans = [(s, e) for _, s, e in inside]
    run.busy_s = busy_seconds(spans)
    for name, s, e in inside:
        run.kernel_us[name] = run.kernel_us.get(name, 0.0) + (e - s)
    labelled = [(n, s, e) for n, s, e in host
                if n != "bench.window" and s < hi and e > lo]
    run.idle_by_host = label_gaps(idle_gaps(spans, (lo, hi)), labelled)


def breakdown(run):
    """The ten device ops that took most time and the ten host
    activities under which the device idled longest, in seconds."""
    ops = sorted(run.kernel_us.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(run.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], us * 1e-6] for n, us in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}


def run_window(run, ctx):
    """Units back to back from the first unit's start until run.seconds
    have passed; the window ends with the last unit that started inside
    it."""
    driver = run.cell.driver
    start = time.perf_counter()
    end = start
    while end - start < run.seconds or run.attempted == 0:
        run.attempted += 1
        try:
            with torch.profiler.record_function("bench.unit"):
                unit = driver.unit(ctx, run)
        except Exception as exc:           # counted, reported, not fatal
            run.failed += 1
            print(f"unit {run.attempted} failed: {exc!r}", file=sys.stderr)
            unit = None
        end = time.perf_counter()
        if unit is not None:
            if unit.pop("ok", True):
                run.units.append(unit)
            else:
                run.failed += 1
    run.window_s = end - start


def card(device):
    """nvidia-smi's "name, power limit" line of the card."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        line = ""
    return line or "nvidia-smi gave nothing"


def written_bytes():
    """{wchar, write_bytes} of this process from /proc: bytes passed to
    write calls, and bytes sent to storage (0 on a memory file system)."""
    out = {}
    try:
        with open("/proc/self/io", encoding="ascii") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def note(msg):
    print(msg, file=sys.stderr, flush=True)


_LAP = [time.perf_counter()]


def lap(label, since=None):
    """Note the seconds of set-up spent on `label`: since the last lap,
    or since `since` (a perf_counter reading)."""
    now = time.perf_counter()
    note(f"set-up: {label} {now - (_LAP[0] if since is None else since):.3f} s")
    _LAP[0] = now


def run_cell(cell, seed, seconds, trace, device, workdir, t_start=None):
    """One run of `cell`: returns the result line's dict (without the
    platform checks of main)."""
    if t_start is None:
        t_start = _LAP[0] = time.perf_counter()
    run = Run(cell, seconds, trace, device)
    ctx = cell.driver.setup(cell, seed, run.device, Path(workdir))
    run.setup_s = time.perf_counter() - t_start
    cuda = run.device.type == "cuda"
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with torch.profiler.record_function("bench.window"):
                run_window(run, ctx)
        t0 = time.perf_counter()
        _read_trace(run, prof)
        del prof
        note(f"trace read in {time.perf_counter() - t0:.3f} s")
    else:
        run_window(run, ctx)
    cell.driver.collect(ctx, run)
    walls = sorted(u["wall"] for u in run.units)
    if walls:
        note(f"unit walls: min {walls[0]:.6f} median "
             f"{walls[len(walls) // 2]:.6f} max {walls[-1]:.6f} s")
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    note(f"window {run.window_s:.6f} s, {len(run.units)} units completed of "
         f"{run.attempted} attempted, {run.failed} failed; set-up "
         f"{run.setup_s:.6f} s; peak device memory {peak} bytes")
    numbers = cell.driver.check(ctx, run)
    from .yardstick.compare import verdict
    correct = run.failed == 0 and verdict(numbers)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else run.device.type,
                         "kind": (torch.cuda.get_device_name(run.device)
                                  if cuda else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = run.window_s
        result["breakdown"] = breakdown(run)
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in numbers.items()}
    return result


def forbidden_modules():
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv, t_start):
    import argparse
    import shutil
    import tempfile

    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = Cell(args.workload)
    lap("python, torch and the program imported", since=t_start)
    if not torch.cuda.is_available():
        note("no CUDA device: the benchmark runs only on a card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        note(f"{cell.name} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.empty(1, device=device)
    lap("CUDA initialised")
    workdir = tempfile.mkdtemp(prefix="rgrff-bench-")
    try:
        with torch.inference_mode():
            result = run_cell(cell, args.seed, args.seconds, args.trace,
                              device, workdir, t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        note(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    note(f"card: {card(device)}; bytes written by this process: "
         f"{written_bytes()}")
    for name, c in result["check"].items():
        note(f"check {name} {c['value']!r} limit {c['limit']!r}")
    note(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0
