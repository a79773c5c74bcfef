"""los_host_ms.compare: the LOS stage handoff on the host, the
"los_download" span (the samples' copy to the host and the host-built ds)
plus the "los_upload" span (the validity mask and the voxel arrays'
copies back to the device), utils/profiling, host clock; mean over the
window's units, ms. None where a unit lacks either span."""

from benchmark.yardstick.spans import map_span_mean_ms


def read(run):
    down = map_span_mean_ms(run, "los_download")
    up = map_span_mean_ms(run, "los_upload")
    if down is None or up is None:
        return None
    return down + up
