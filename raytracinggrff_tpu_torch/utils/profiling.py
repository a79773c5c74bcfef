"""The port's tracing: spans of the program's work, stage timing and
device traces on torch (raytracinggrff_tpu/utils/profiling.py).

`span(name)` marks a piece of the program's work. It records into the
active Recorder, if there is one, and while torch.profiler records it also
opens record_function("rgrff.<name>"), so that a device trace names the
program's spans on the host timeline. With neither, a span is one check
and a shared no-op. A Recorder is active inside `with recording(device)`:
run_ray_tracing_emission opens one when given a `timings` dict, run_sweep
one a map when given a `timings` list. A recording opened inside another
is nested in it: each span it records is recorded in the outer one too,
so an operator's recording around a map sees the map's spans while the
map's `timings` hold its own. A span nested in another records that one
as its parent. A host span reads time.perf_counter. A device span, around
queued device work, reads CUDA events on the current stream when the
innermost recording's device is a CUDA device, read after one synchronize
(Recorder.totals), so that asynchronous launches are charged to the span
that queued them; otherwise it reads the host clock. `count(name, value)`
adds to a counter of the active recording and those it is nested in;
callers take a count only where `counting()` says so, so that untraced
work counts nothing.

StageTimer keeps the JAX package's API; given a CUDA device it
synchronizes that device at the end of each stage. device_trace records a
torch.profiler trace of the host and the device, spans included, and
writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from pathlib import Path

import torch

PREFIX = "rgrff."
_ACTIVE = contextvars.ContextVar("raytracinggrff_recorder", default=None)
_OFF = contextlib.nullcontext()


class Span:
    """One span of the program's work: its name, the span it ran inside
    (None at the top), its clock ("host" or "device") and its begin and
    end marks (perf_counter seconds, or CUDA events)."""

    __slots__ = ("name", "parent", "clock", "begin", "end", "_recorder",
                 "_annotation", "_seconds")

    def __init__(self, name, clock, recorder, annotate):
        self.name, self.clock, self._recorder = name, clock, recorder
        self.parent = self.begin = self.end = self._seconds = None
        self._annotation = (torch.profiler.record_function(PREFIX + name)
                            if annotate else None)

    def __enter__(self):
        if self._annotation is not None:
            self._annotation.__enter__()
        rec = self._recorder
        if rec is not None:
            self.parent = rec._open[-1] if rec._open else None
            rec._open.append(self)
            self.begin = rec._mark(self.clock)
        return self

    def __exit__(self, *exc):
        rec = self._recorder
        if rec is not None:
            self.end = rec._mark(self.clock)
            rec._open.pop()
            # no reference back: a recorder and its spans are freed
            # without the cycle collector
            self._recorder = None
            while rec is not None:
                rec.spans.append(self)
                rec = rec.outer
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        return False

    def seconds(self):
        """The span's seconds, read once: a span recorded in nested
        recordings is totalled by each, and reading CUDA events queries
        the device."""
        if self._seconds is None:
            self._seconds = (self.end - self.begin
                             if isinstance(self.begin, float)
                             else self.begin.elapsed_time(self.end) / 1e3)
        return self._seconds


class Recorder:
    """The spans of one identity, such as one map, in the order they
    ended. `outer` is the recording it is nested in, or None; nested
    recordings share their open spans, so a span's parent may have been
    opened in an outer one."""

    def __init__(self, device, outer=None):
        self.cuda = torch.device(device).type == "cuda"
        self.outer = outer
        self.spans = []
        self.counts = {}
        self._open = outer._open if outer is not None else []

    def _mark(self, clock):
        if clock == "device" and self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def totals(self):
        """{span name: its spans' seconds summed}, after one synchronize
        where a span holds CUDA events."""
        if any(not isinstance(s.begin, float) for s in self.spans):
            torch.cuda.synchronize()
        out = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.seconds()
        return out

    def counters(self):
        """{counter name: its values summed}, each an int; a device
        tensor's value is read here, which waits for the device."""
        return {name: sum(int(v) for v in values)
                for name, values in self.counts.items()}


@contextlib.contextmanager
def recording(device):
    """Make a new Recorder active for the block and yield it. `device`
    sets the clock of its device spans: CUDA events on a CUDA device,
    else the host clock. Inside an active recording the new one is nested
    in it."""
    rec = Recorder(device, _ACTIVE.get())
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)


def span(name, clock="host"):
    """A context manager that records the block as span `name` on its
    `clock` ("host" or "device") into the active Recorder, and opens
    record_function("rgrff.<name>") while torch.profiler records. With
    clock None it only does the second."""
    rec = _ACTIVE.get() if clock is not None else None
    annotate = torch.autograd._profiler_enabled()
    if rec is None and not annotate:
        return _OFF
    return Span(name, clock, rec, annotate)


def counting():
    """Whether a count is to be taken: a recording is active and
    torch.profiler records (as the maps' fold counts are taken). Untraced
    work, and work outside a recording, counts nothing."""
    return _ACTIVE.get() is not None and torch.autograd._profiler_enabled()


def count(name, value):
    """Add `value` (an int, or a one-element integer tensor, read when the
    recording's counters are read) to counter `name` of the active
    recording and of those it is nested in."""
    rec = _ACTIVE.get()
    while rec is not None:
        rec.counts.setdefault(name, []).append(value)
        rec = rec.outer


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
    Chrome trace (chrome://tracing, Perfetto) in which the program's
    spans appear as rgrff.<name>. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
