"""host_s.sweep: a sweep's wall minus the stages of all its maps (model
set-up, cube-set changes, the .npz writes), mean over the window's
sweeps, s."""

from benchmark.yardstick.readings import sweep_host_mean_s


def read(run):
    return sweep_host_mean_s(run)
