"""Median over the window's fits of the host stages' milliseconds: every
stage of ``FlashDeconv.timings_`` except ``solve`` (gene selection,
preprocessing, sketch, spatial graph, lambda)."""

import statistics


def read(run):
    timings = [r["timings"] for r in run["records"] if "timings" in r]
    if not timings:
        return None
    return statistics.median(
        1e3 * sum(v for k, v in t.items() if k != "solve") for t in timings)
