"""ray_ms.compare: the "ray" span (compare_frequency's ray-traced map,
run_ray_tracing_emission from the MAS directory to its .npz,
utils/profiling, host clock), mean over the window's units, ms."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    return map_span_mean_ms(run, "ray")
