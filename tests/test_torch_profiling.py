"""The port's tracing (utils/profiling.py) on the CPU: spans nest and name
their parent, a recording nested in another records into both, one map's
spans share one recorder, the profiler sees them as rgrff.<name>, the
sweep's per-map dicts keep their keys, and with tracing off nothing
runs."""

import contextlib
import gc
import weakref

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytracinggrff_tpu_torch.cli import tb_spectra
from raytracinggrff_tpu_torch.mas.model import synthetic_mas_model
from raytracinggrff_tpu_torch.pipeline import (RayEmissionConfig,
                                               run_ray_tracing_emission)
from raytracinggrff_tpu_torch.utils import profiling

# a map of two segments, of 4 and 2 records
PRESET = dict(grid_n=24, grid_extent=1.5, z_observer=1.5, x_fov=1.3,
              dt=0.5, n_steps=60, record_stride=10)
TINY = dict(PRESET, n_pix=8, freq_hz=150e6, seg_records=4)
STAGES = {"resample", "trace", "transfer", "finish"}
SWEEP_KEYS = {"idx", "freq_hz", *PRESET, "records", *STAGES, "segments",
              "peak_bytes"}


@pytest.fixture(scope="module")
def corona(tmp_path_factory):
    return synthetic_mas_model(tmp_path_factory.mktemp("corona"), nphi=16,
                               ntheta=12, nr=14)


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def program_events(prof):
    """{rgrff.<name>: [(start_ns, end_ns)]} of a finished profiler."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def tiny_map(corona, **kw):
    return run_ray_tracing_emission(model_path=corona,
                                    config=RayEmissionConfig(**TINY),
                                    verbose=False, device="cpu", **kw)


def test_spans_nest_and_name_their_parent():
    with profiling.recording("cpu") as rec:
        with profiling.span("outer") as outer:
            with profiling.span("inner", "device") as inner:
                with profiling.span("leaf") as leaf:
                    pass
            with profiling.span("inner") as again:
                pass
        with profiling.span("top") as top:
            pass
    assert [s.name for s in rec.spans] == ["leaf", "inner", "inner",
                                           "outer", "top"]
    assert leaf.parent is inner and inner.parent is outer
    assert again.parent is outer
    assert outer.parent is None and top.parent is None
    # a device span reads the host clock on a CPU recorder
    assert inner.clock == "device" and isinstance(inner.begin, float)
    totals = rec.totals()
    assert totals["inner"] == pytest.approx(inner.seconds()
                                            + again.seconds())
    assert totals["outer"] >= totals["inner"] >= leaf.seconds() >= 0.0
    assert set(totals) == {"outer", "inner", "leaf", "top"}


def test_a_recording_inside_another_records_into_both():
    with profiling.recording("cpu") as outer:
        with profiling.span("around") as around:
            with profiling.recording("cpu") as inner:
                assert inner is not outer and inner.outer is outer
                with profiling.span("a") as a:
                    pass
        with profiling.span("b"):
            pass
    assert [s.name for s in inner.spans] == ["a"]
    assert [s.name for s in outer.spans] == ["a", "around", "b"]
    assert a.parent is around                # opened in the outer one
    assert set(inner.totals()) == {"a"}
    with profiling.span("after") as nothing:
        assert nothing is None


def test_a_recording_is_freed_without_the_cycle_collector():
    gc.disable()
    try:
        with profiling.recording("cpu") as rec:
            with profiling.span("outer"):
                with profiling.span("inner"):
                    pass
        ref = weakref.ref(rec)
        del rec
        assert ref() is None
    finally:
        gc.enable()


def test_each_map_in_an_operators_recording_times_its_own(corona,
                                                          tmp_path):
    """Two maps inside an operator's recording: each map's timings hold
    its own spans, the operator's recording both maps'."""
    first, second = {}, {}
    with profiling.recording("cpu") as rec:
        tiny_map(corona, out_path=str(tmp_path / "a.npz"), timings=first)
        tiny_map(corona, out_path=str(tmp_path / "b.npz"), timings=second)
    writes = [s.seconds() for s in rec.spans if s.name == "write"]
    assert len(writes) == 2
    assert (first["write"], second["write"]) == tuple(writes)
    assert len([s for s in rec.spans if s.name == "trace"]) == 6
    assert rec.totals()["trace"] == pytest.approx(first["trace"]
                                                  + second["trace"])


def test_off_enters_no_record_function_and_records_nothing(corona,
                                                          monkeypatch):
    """With no recorder and no profiler a span is the shared no-op; with
    a recorder alone spans record but no record_function is entered;
    under the profiler each span enters one."""
    names = []
    real = torch.profiler.record_function

    class Counting(real):
        def __init__(self, name, *args, **kwargs):
            names.append(name)
            super().__init__(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert profiling.span("x") is profiling.span("y", "device")
    assert profiling.span("z", clock=None) is profiling.span("x")
    tiny_map(corona)
    assert names == []
    with profiling.recording("cpu") as rec:
        tiny_map(corona)
    assert names == []
    assert {s.name for s in rec.spans} == STAGES | {"read", "upload",
                                                     "rays", "trace_inputs"}
    with cpu_profile():
        with profiling.span("x"):
            pass
        with profiling.span("y", clock=None):
            pass
    assert names == ["rgrff.x", "rgrff.y"]


def test_profiler_sees_map_resample_read_nested(corona):
    with cpu_profile() as prof:
        tiny_map(corona)
    spans = program_events(prof)

    def within(inner, outer):
        return all(any(o[0] <= i[0] and i[1] <= o[1] for o in spans[outer])
                   for i in spans[inner])

    assert within("rgrff.resample", "rgrff.map")
    assert within("rgrff.read", "rgrff.resample")
    assert within("rgrff.upload", "rgrff.resample")
    assert within("rgrff.trace_inputs", "rgrff.trace")
    assert within("rgrff.finish", "rgrff.map")
    assert len(spans["rgrff.map"]) == 1
    assert len(spans["rgrff.transfer"]) == 2     # one a segment
    assert len(spans["rgrff.trace"]) == 3        # and the generator's end


@pytest.mark.parametrize("write", [True, False])
def test_map_timings_name_every_span(corona, tmp_path, write):
    """run_ray_tracing_emission(model_path=...) returns the stages and
    the spans inside them; resample holds the read and the upload, trace
    the trace inputs."""
    timings = {}
    out = str(tmp_path / "map.npz") if write else None
    tiny_map(corona, out_path=out, timings=timings)
    spans = {"read", "upload", "rays", "trace_inputs"} | (
        {"write"} if write else set())
    counts = {"segments"} | ({"write_chunks", "write_threads"} if write
                             else set())
    assert set(timings) == STAGES | spans | counts
    assert timings["segments"] == 2
    assert all(timings[k] >= 0.0 for k in STAGES | spans)
    assert timings["resample"] >= timings["read"] + timings["upload"]
    assert timings["trace"] >= timings["trace_inputs"]


@pytest.mark.parametrize("traced", [False, True])
def test_sweep_map_dicts_keep_their_keys(corona, tmp_path, monkeypatch,
                                         traced):
    """Two maps on one cube set: each dict keeps the keys it had; the
    cube set's resample, with its read and upload, is a span of the map
    that made it; the rgrff.sweep span comes only under the profiler."""
    monkeypatch.setattr(tb_spectra, "select_params",
                        lambda f: dict(PRESET))
    timings = []
    with cpu_profile() if traced else contextlib.nullcontext() as prof:
        tb_spectra.run_sweep(corona, [100e6, 120e6], tmp_path, n_pix=8,
                             exact_presets=True, device="cpu",
                             timings=timings, verbose=False)
    first, second = timings
    for m in timings:
        assert SWEEP_KEYS <= set(m) and m["peak_bytes"] is None
        assert m["segments"] == 1 and m["write"] >= 0.0
    assert first["resample"] >= first["read"] + first["upload"]
    assert "read" not in second and "upload" not in second
    if traced:
        assert {"rgrff.sweep", "rgrff.map", "rgrff.read",
                "rgrff.write"} <= set(program_events(prof))


def test_device_trace_writes_the_spans(tmp_path):
    with profiling.device_trace(tmp_path / "trace"):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(3).sum()
    text = (tmp_path / "trace" / "trace.json").read_text()
    assert '"rgrff.outer"' in text and '"rgrff.inner"' in text
