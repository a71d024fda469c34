"""95th percentile of the latency of every solve of the window, ms (each
solve timed to the end of its device work)."""

import numpy as np


def read(run):
    if not run["records"]:
        return None
    ms = [(r["t1"] - r["t0"]) * 1e3 for r in run["records"]]
    return float(np.percentile(ms, 95))
