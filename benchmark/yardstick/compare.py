"""The comparison that decides `correct`: gaps between what the program
produced and what the plain reference computes for the same inputs.

Every gap is a maximum over the compared values. A value that is NaN on
one side and a number on the other reads as MISMATCH; NaN on both sides
reads as no gap.
"""

from __future__ import annotations

import numpy as np

MISMATCH = 3.4e38
# T_b below this many kelvin is compared as if it were this large: the
# maps' validity range starts at 1e4 K, and off-limb pixels of a few K
# would otherwise turn rounding into large relative gaps
TB_FLOOR_K = 1e4


def _gap(got, want, scale):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    if np.any(nan_g != nan_w):
        return MISMATCH
    both = ~nan_g
    if not both.any():
        return 0.0
    d = np.abs(got[both] - want[both]) / scale(want[both])
    d = np.where(np.isfinite(d), d, MISMATCH)
    return float(d.max())


def abs_gap(got, want):
    """Largest absolute difference."""
    return _gap(got, want, lambda w: 1.0)


def rel_gap(got, want, floor):
    """Largest difference relative to max(|want|, floor)."""
    return _gap(got, want, lambda w: np.maximum(np.abs(w), floor))


def record_gaps(got, want):
    """Gaps of trace records (n_records, 8, n) against the reference's:
    positions (rows 0-2, R_sun, absolute), S (row 3, relative) and the
    sampled ne, te, b (rows 4-6, relative)."""
    return {"pos_gap": abs_gap(got[:, 0:3], want[:, 0:3]),
            "s_gap": rel_gap(got[:, 3], want[:, 3], 1e-30),
            "field_gap": max(rel_gap(got[:, i], want[:, i], 1e-30)
                             for i in (4, 5, 6))}


def map_gaps(tb_got, tb_want, vi_got, vi_want):
    """Gaps of T_b (relative to max(T_b, TB_FLOOR_K)) and of V/I
    (absolute) against the reference's."""
    return {"tb_gap": rel_gap(tb_got, tb_want, TB_FLOOR_K),
            "vi_gap": abs_gap(vi_got, vi_want)}


def verdict(numbers):
    """Whether every compared number lies at or below its limit:
    `numbers` {name: (value, limit)}."""
    return all(np.isfinite(v) and v <= lim for v, lim in numbers.values())
