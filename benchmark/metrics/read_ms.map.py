"""read_ms.map: the map's "read" span (the HDF4 reads of prepare_cubes,
utils/profiling, host clock), mean over the window's maps, ms."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    return map_span_mean_ms(run, "read")
