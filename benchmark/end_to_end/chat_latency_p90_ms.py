"""90th percentile (linear interpolation between order statistics) of the wall
time of every request completed in the window, from images and question in
host memory to the answer string."""

import numpy as np


def read(ctx):
    lat = ctx.latencies()
    return float(np.percentile(lat, 90)) * 1e3 if lat else None
