"""Median over the window's fits of ``timings_["solve"]`` in ms: prepare,
the solve, the device outputs and the fetch of the proportions."""

import statistics


def read(run):
    ms = [1e3 * r["timings"]["solve"] for r in run["records"]
          if "solve" in r.get("timings", {})]
    return statistics.median(ms) if ms else None
