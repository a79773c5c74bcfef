"""s_per_frequency: the window's wall over (maps completed x nfreq)
(host clock)."""


def read(run):
    if not run.units:
        return None
    return run.window_s / sum(u["nfreq"] for u in run.units)
