"""voxel_fold_roofline.compare: the voxel fold's least time (the frozen
fold_voxels_bound_ms of each unit's fold of the configuration's n_pix^2
pixels x n_z voxels, with the counts of voxels flagged valid and voxels
taken, which the program gives in a unit's timings while traced; the
LOS map's frequencies and mechanism from the configuration) over the
fold_voxels_kernel device time in the profiler's events, summed over the
traced window, %. None without counts."""

from benchmark.drivers.common import map_settings
from benchmark.yardstick.los_roofline import voxel_fold_roofline


def read(run):
    if not run.units:
        return None
    los = run.cell.config["los"]
    return voxel_fold_roofline(run, map_settings(run.cell)["n_pix"] ** 2,
                               los["n_z"], los["nfreq"], los["mechanism"])
