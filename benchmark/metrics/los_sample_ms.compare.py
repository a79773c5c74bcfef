"""los_sample_ms.compare: the "los_sample" span (resample_mas_los's
coordinate block, its one sampler launch, the masks and casts,
utils/profiling, CUDA events), mean over the window's units, ms."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    return map_span_mean_ms(run, "los_sample")
