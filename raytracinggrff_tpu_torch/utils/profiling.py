"""Stage timing and device traces on torch
(raytracinggrff_tpu/utils/profiling.py).

StageTimer keeps the JAX package's API. Torch launches are asynchronous,
so given a CUDA device it synchronizes that device at the end of each
stage: the work a stage queued is charged to it, as in
pipeline.StageClock. device_trace records a torch.profiler trace of the
host and the device and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


class StageTimer:
    """Accumulating named stage timer.

    timer = StageTimer(device="cuda")
    with timer.stage("trace"): ...
    print(timer.report())
    """

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = {}
        self.counts = {}

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        lines = []
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total:9.3f}s  x{n}"
                         f"  ({total / n:.3f}s avg)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir):
    """Profile the block with torch.profiler (CPU activities, and CUDA
    ones when a card is present) and write it to log_dir/trace.json, a
    Chrome trace (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
