"""The record fold's operations, bytes and bound: a frozen copy of
chip_smoke.py's FOLD_FLOPS_* constants, fold_flops and the arithmetic of
fold_records_bound, and of raytracinggrff_tpu_torch/tracer_segments.
segment_plan, so that a change to the program cannot move the yardstick.

fold_bound_ms takes a segment's counts of records stepped from and taken,
which the program counts where the fold runs (a map's
timings["fold_counts"]), where chip_smoke counts them from the records
themselves; the arithmetic is the same.
"""

from __future__ import annotations

from .roofline import bound

# float32 operations of csrc/transfer_fold.cu a valid voxel, counted as
# chip_smoke.py counts them: (once a voxel, once a (voxel, frequency)) of
# each term, and FOLD_FLOPS_RECORD once a record (ds from the last valid
# position), with 1 more for S x area and 3 for theta from row 7
FOLD_FLOPS_RECORD = 10
FOLD_FLOPS_COMMON = (5, 45)
FOLD_FLOPS_FF = {"dulk": (8, 9), "exact": (8, 10)}
FOLD_FLOPS_NEUTRALS = (13, 10)
FOLD_FLOPS_GR, FOLD_FLOPS_HARMONIC = (11, 64), (13, 7)
# the record fold's highest harmonic (ops/transfer_fold.fold_records)
S_MAX = 30
# the kernel's name in the profiler's events
KERNEL = "fold_records_kernel"


def fold_flops(nf, mechanism, gaunt, s_max=S_MAX):
    """float32 operations of one valid voxel of the fold at nf
    frequencies, beyond those of its record."""
    terms = [FOLD_FLOPS_COMMON]
    if mechanism & 1:
        terms.append(FOLD_FLOPS_FF[gaunt])
        if mechanism & 4:
            terms.append(FOLD_FLOPS_NEUTRALS)
    if mechanism & 2:
        terms += [FOLD_FLOPS_GR] + [FOLD_FLOPS_HARMONIC] * max(0, s_max - 1)
    return sum(once + nf * per_freq for once, per_freq in terms)


def fold_bound_ms(n_stepped, n_taken, rps, n_rays, nf, mechanism,
                  gaunt="dulk", s_on=True, theta_los=False, s_max=S_MAX):
    """Least time for one record fold of rps records of n_rays rays, of
    which n_stepped were valid and n_taken taken. Operations: those of the
    records taken. Bytes: of every record the rows that decide its
    validity (0-3, and 7 with theta_los), rows 4-6 of the valid ones, the
    carry and the last valid positions read and written once. Returns
    (ms, "operations" or "bytes")."""
    per_rec = FOLD_FLOPS_RECORD + int(s_on) + 3 * int(theta_los)
    ops = n_taken * (per_rec + fold_flops(nf, mechanism, gaunt, s_max))
    n = n_rays
    nbytes = 4 * ((4 + int(theta_los)) * rps * n + 3 * n_stepped
                  + 2 * 4 * n * nf + 2 * 3 * n + nf)
    return bound(ops, nbytes)


def segment_records(n_steps, record_stride, seg_records):
    """Records of each trace segment: the first record after step 1, then
    one every record_stride steps, seg_records a segment."""
    n_records = -(-n_steps // record_stride)
    return [min(seg_records, n_records - done)
            for done in range(0, n_records, seg_records)]


def map_fold_roofline(run, settings):
    """The record fold's least time, summed over the segments of the
    window's maps from their timings["fold_counts"], over the fold
    kernel's device time in the window's profiler events, %. `settings`:
    the map's RayEmissionConfig fields. None where no map carries counts
    (a program that does not count) or no fold kernel ran."""
    units = [u for u in run.units if "fold_counts" in u.get("timings", {})]
    kernel_us = sum(us for name, us in run.kernel_us.items()
                    if KERNEL in name)
    if not units or not kernel_us:
        return None
    plan = segment_records(settings["n_steps"], settings["record_stride"],
                           settings["seg_records"])
    bound_ms = 0.0
    for u in units:
        counts = u["timings"]["fold_counts"]
        if len(counts) != len(plan):
            return None
        for rps, (stepped, taken) in zip(plan, counts):
            bound_ms += fold_bound_ms(
                stepped, taken, rps, settings["n_pix"] ** 2,
                settings["nfreq"], settings["mechanism"], settings["gaunt"],
                settings["s_input_on"], settings["theta_mode"] == "los")[0]
    return 100.0 * bound_ms / (kernel_us / 1e3)
