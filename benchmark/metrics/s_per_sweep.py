"""s_per_sweep: the window's wall over the sweeps completed (host
clock)."""


def read(run):
    if not run.units:
        return None
    return run.window_s / len(run.units)
