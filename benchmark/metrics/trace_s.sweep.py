"""trace_s.sweep: the "trace" stage summed over a sweep's maps
(run_sweep's timings), mean over the window's sweeps, s."""

from benchmark.yardstick.readings import sweep_stage_mean_s


def read(run):
    return sweep_stage_mean_s(run, "trace")
