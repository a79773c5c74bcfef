"""write_s.sweep: the "write" span (np.savez_compressed of each map's
.npz, utils/profiling, host clock) summed over a sweep's maps, mean over
the window's sweeps, s."""

from benchmark.yardstick.spans import sweep_span_mean_s


def read(run):
    return sweep_span_mean_s(run, "write")
