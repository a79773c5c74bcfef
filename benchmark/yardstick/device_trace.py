"""Reading the profiler's trace: device intervals, their union, the idle
gaps between them and what the host was doing in each.

busy_seconds is a frozen copy of profile_slice.py's, taking (start, end)
pairs in microseconds where that one takes the events themselves.
"""

from __future__ import annotations

import bisect

import numpy as np


def busy_seconds(spans):
    """Length of the union of the [start, end] intervals (microseconds),
    in seconds."""
    busy, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy * 1e-6


def merged(spans):
    """The union of the intervals as sorted disjoint [start, end] pairs."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_gaps(device_spans, window):
    """The device's idle intervals inside `window` (start, end), in
    microseconds."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in merged(device_spans):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, host_events, fallback="host, outside torch"):
    """{label: idle seconds}: each gap labelled by the innermost host
    event (name, start, end) that covers its midpoint, else `fallback`."""
    host = sorted(host_events, key=lambda ev: ev[1])
    starts = [ev[1] for ev in host]
    totals = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid)
        best = None
        # host events nest; the covering ones start at most a few hundred
        # events back
        for name, hs, he in host[max(0, i - 400):i][::-1]:
            if he >= mid and (best is None or he - hs < best[1]):
                best = (name, he - hs)
        label = best[0] if best else fallback
        totals[label] = totals.get(label, 0.0) + (e - s) * 1e-6
    return totals
