"""Median over the window's fits of ``timings_["sketch"]`` in ms: the host
time of the ``flashdeconv.fit.sketch`` stage (the fused Xty pass, streamed
to the card), whose ``StageTimer`` entry and profiler span cover the same
interval."""

import statistics


def read(run):
    ms = [1e3 * r["timings"]["sketch"] for r in run["records"]
          if "sketch" in r.get("timings", {})]
    return statistics.median(ms) if ms else None
