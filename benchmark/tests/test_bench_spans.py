"""The readers of the program's spans on hand-built runs: the numbers they
should give, and None where the program carries no such span."""

import pytest

from benchmark.harness import Run, reader

SPAN_READERS = ("read_ms.map", "write_ms.map", "read_s.sweep",
                "write_s.sweep", "trace_inputs_s.sweep")


def run_of(units):
    run = Run(None, 1.0, 1, "cpu")
    run.units = units
    return run


def map_unit(**spans):
    stages = dict(resample=0.05, trace=0.05, transfer=0.001, finish=0.005)
    return {"wall": 0.4, "nfreq": 3, "timings": {**stages, **spans}}


def test_map_span_readers_average_over_maps():
    run = run_of([map_unit(read=0.010, write=0.300),
                  map_unit(read=0.020, write=0.400)])
    assert reader("read_ms.map")(run) == pytest.approx(15.0)
    assert reader("write_ms.map")(run) == pytest.approx(350.0)


def test_sweep_span_readers_sum_maps_and_average_sweeps():
    # the second map of each sweep reuses the cube set: no read
    sweeps = [{"wall": 3.0, "timings": [
        dict(read=0.1, write=0.04, trace_inputs=0.02),
        dict(write=0.05, trace_inputs=0.01)]},
        {"wall": 3.2, "timings": [
            dict(read=0.3, write=0.06, trace_inputs=0.03),
            dict(write=0.05, trace_inputs=0.02)]}]
    run = run_of(sweeps)
    assert reader("read_s.sweep")(run) == pytest.approx(0.2)
    assert reader("write_s.sweep")(run) == pytest.approx(0.1)
    assert reader("trace_inputs_s.sweep")(run) == pytest.approx(0.04)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_span_readers_read_none_without_the_program_span(name):
    """A program without the spans (the stages alone, as before them), or
    a window with no unit, reads None, never 0."""
    maps = run_of([map_unit(), map_unit()])
    sweeps = run_of([{"wall": 3.0, "timings": [
        dict(resample=0.1, trace=1.0, transfer=0.01, finish=0.01)]}])
    empty = run_of([])
    cell = maps if name.endswith(".map") else sweeps
    assert reader(name)(cell) is None
    assert reader(name)(empty) is None
