"""device_idle.trace: 100 x (1 - the union of the device's operation
intervals over the traced window's wall), under torch.profiler."""

from benchmark.yardstick.readings import device_idle_pct


def read(run):
    return device_idle_pct(run)
