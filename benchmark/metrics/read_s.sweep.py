"""read_s.sweep: the "read" span (the HDF4 reads of each cube set's
prepare_cubes, utils/profiling, host clock) summed over a sweep's maps,
mean over the window's sweeps, s."""

from benchmark.yardstick.spans import sweep_span_mean_s


def read(run):
    return sweep_span_mean_s(run, "read")
