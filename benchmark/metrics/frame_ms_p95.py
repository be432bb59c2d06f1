"""The 95th percentile of the latency of every frame sent in the window,
from its ``enqueue`` to the return of its ``get()``, in ms (numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(run):
    lat = [1e3 * (r.t_done - r.t_sent) for r in run.window.requests]
    return float(np.percentile(lat, 95)) if lat else None
