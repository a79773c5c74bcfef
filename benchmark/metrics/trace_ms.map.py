"""trace_ms.map: the map's "trace" stage (pipeline.StageClock, CUDA
events on the stream), mean over the window's maps, ms."""

from benchmark.yardstick.readings import map_stage_mean_ms


def read(run):
    return map_stage_mean_ms(run, "trace")
