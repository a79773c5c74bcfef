"""Arithmetic that the metric readers share, over a run's completed
units (benchmark/harness.Run)."""

from __future__ import annotations

STAGES = ("resample", "trace", "transfer", "finish")


def map_stage_mean_ms(run, stage):
    """Mean over the window's maps of one stage of their timings, in ms;
    None without maps."""
    units = [u for u in run.units if "timings" in u]
    if not units:
        return None
    return 1e3 * sum(u["timings"][stage] for u in units) / len(units)


def map_host_mean_ms(run):
    """Mean over the window's maps of the wall outside the stages, ms."""
    units = [u for u in run.units if "timings" in u]
    if not units:
        return None
    return 1e3 * sum(u["wall"] - sum(u["timings"][s] for s in STAGES)
                     for u in units) / len(units)


def sweep_stage_mean_s(run, stage):
    """Mean over the window's sweeps of one stage summed over each
    sweep's maps, in s."""
    if not run.units:
        return None
    return sum(sum(m[stage] for m in u["timings"])
               for u in run.units) / len(run.units)


def sweep_host_mean_s(run):
    """Mean over the window's sweeps of the wall outside every map's
    stages, s."""
    if not run.units:
        return None
    return sum(u["wall"] - sum(m[s] for m in u["timings"] for s in STAGES)
               for u in run.units) / len(run.units)


def device_idle_pct(run):
    """The share of the traced window in which no operation ran on the
    device, %; None without a device trace."""
    if not run.busy_s or not run.window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
