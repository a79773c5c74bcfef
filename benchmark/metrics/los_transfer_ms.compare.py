"""los_transfer_ms.compare: the "los_transfer" span (synthetic_ff's
get_mw_slice, one voxel-fold launch, utils/profiling, CUDA events), mean
over the window's units, ms."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    return map_span_mean_ms(run, "los_transfer")
