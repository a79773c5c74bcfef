"""write_ms.map: the map's "write" span (np.savez_compressed of the .npz,
utils/profiling, host clock), mean over the window's maps, ms."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    return map_span_mean_ms(run, "write")
