"""map_p90_s: the 90th percentile of the wall of every map completed in
the window, each from call to return (host clock; numpy's linear
interpolation). A window of about a hundred maps leaves some ten beyond
it."""

import numpy as np


def read(run):
    if not run.units:
        return None
    return float(np.percentile([u["wall"] for u in run.units], 90))
