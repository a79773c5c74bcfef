"""trace_roofline.trace: the trace kernel's least time (the frozen
segment_bound_ms over each segment's live rays) over its device time in
the profiler's events, summed over the traced window, %."""


def read(run):
    bound, kernel = (run.extra.get("trace_bound_ms"),
                     run.extra.get("trace_kernel_ms"))
    if not bound or not kernel:
        return None
    return 100.0 * bound / kernel
