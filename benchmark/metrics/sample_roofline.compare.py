"""sample_roofline.compare: the spherical sampler's least time (the frozen
sample_bound_ms of one launch a unit at the configuration's n_pix^2 x n_z
points on its scene, los_roofline.sample_counts) over the
sample_sph_kernel device time in the profiler's events, summed over the
traced window, %. None without units or without the kernel."""

from benchmark.drivers.common import map_settings
from benchmark.yardstick.los_roofline import sample_counts, sample_roofline


def read(run):
    if not run.units:
        return None
    config = run.cell.config
    return sample_roofline(run, *sample_counts(
        map_settings(run.cell)["n_pix"], config["los"]["n_z"],
        config["scene"]))
