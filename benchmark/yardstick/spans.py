"""Arithmetic over the program's own spans (the keys that
run_ray_tracing_emission's and run_sweep's `timings` receive from
utils/profiling), for the metric readers. Each returns None where no
completed unit carries the key, as a program without that span gives."""

from __future__ import annotations


def map_span_mean_ms(run, name):
    """Mean over the window's maps of span `name`'s seconds, in ms."""
    units = [u for u in run.units if name in u.get("timings", {})]
    if not units:
        return None
    return 1e3 * sum(u["timings"][name] for u in units) / len(units)


def sweep_span_mean_s(run, name):
    """Mean over the window's sweeps of span `name`'s seconds summed over
    each sweep's maps (a map that did not run the span adds 0), in s."""
    if not any(name in m for u in run.units for m in u["timings"]):
        return None
    return sum(sum(m.get(name, 0.0) for m in u["timings"])
               for u in run.units) / len(run.units)
