"""ray_steps_per_s: rays x steps run of every trace completed in the
window, over the window's wall (host clock; each trace ends in a
synchronize)."""


def read(run):
    if not run.units:
        return None
    return sum(u["ray_steps"] for u in run.units) / run.window_s
