"""fold_roofline.map: the record fold's least time (the frozen
fold_bound_ms over each segment's counts of records stepped from and
taken, which the program gives in a map's timings["fold_counts"] while
traced) over the fold kernel's device time in the profiler's events,
summed over the traced window, %. None without counts."""

from benchmark.drivers.common import map_settings
from benchmark.yardstick.fold_roofline import map_fold_roofline


def read(run):
    if not run.units:
        return None
    return map_fold_roofline(run, map_settings(run.cell))
