"""host_ms.map: a map's wall minus the sum of its stages (MASModel
set-up, ray starts, the .npz write), mean over the window's maps, ms."""

from benchmark.yardstick.readings import map_host_mean_ms


def read(run):
    return map_host_mean_ms(run)
