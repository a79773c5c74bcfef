"""The trace kernel's operations, bytes and bound: a frozen copy of
chip_smoke.py's bound and segment_bound_ms with their constants, and of
raytracinggrff_tpu_torch/harness.steps_run, so that a change to the
program cannot move the yardstick.

segment_bound_ms takes the per-record counts of live rays (record blocks
that end with S > 0) where chip_smoke takes the record block itself; the
arithmetic is the same.
"""

from __future__ import annotations

import numpy as np

# The H100 SXM's peak float32 rate outside the tensor cores and its memory
# rate (NVIDIA's data sheet, at 700 W).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# float32 operations of csrc/trace_segment.cu, counting each add,
# multiply, divide and square root as one. A cross-section step is the
# central RK4 (4 evaluations of 118 + 80) 552, the transverse basis 52,
# two perturbed RK4s (4 evaluations + 65 each) 1074 and the area ratio 24.
# A record is locate 9 + 91 per float4 group + 1 (+ 19 for cos theta with
# 8 channels).
FLOPS_PER_STEP = 1702
FLOPS_PER_RECORD = {4: 101, 8: 211}


def steps_run(n_steps, record_stride):
    """RK4 steps a trace of n_steps runs: the first record after step 1,
    then one every record_stride steps, none after the last record."""
    n_records = -(-n_steps // record_stride)
    return 1 + (n_records - 1) * record_stride


def bound(ops, nbytes):
    """(ms, "operations" or "bytes"): the larger of ops at PEAK_F32_FLOPS
    and nbytes at PEAK_BYTES_S."""
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def segment_ops(live, n_first, stride, sample_channels):
    """float32 operations of one segment: only steps of rays still in the
    cube count, `live` (rps,) the rays whose record block ends with
    S > 0."""
    live = np.asarray(live, np.float64)
    steps = np.full(live.shape[0], float(stride))
    steps[0] = n_first
    return (FLOPS_PER_STEP * float((live * steps).sum())
            + FLOPS_PER_RECORD[sample_channels] * float(live.sum()))


def segment_bound_ms(tcube_numel, scube_numel, sample_channels, state_numel,
                     rec_numel, live, n_first, stride):
    """Least time the card needs for one segment: the larger of its
    operations (segment_ops) at PEAK_F32_FLOPS and its bytes (each cube,
    the state in and out and the records once) at PEAK_BYTES_S. Returns
    (ms, "operations" or "bytes")."""
    ops = segment_ops(live, n_first, stride, sample_channels)
    nbytes = 4 * (tcube_numel + scube_numel + 2 * state_numel + rec_numel)
    return bound(ops, nbytes)
