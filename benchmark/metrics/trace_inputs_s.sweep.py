"""trace_inputs_s.sweep: the "trace_inputs" span (the stacked kernel
cubes and the start state of each map's trace, utils/profiling, CUDA
events; part of "trace") summed over a sweep's maps, mean over the
window's sweeps, s."""

from benchmark.yardstick.spans import sweep_span_mean_s


def read(run):
    return sweep_span_mean_s(run, "trace_inputs")
