"""Median over the window's fits of ``timings_["gene_selection"]`` in ms:
the host time of the ``flashdeconv.fit.gene_selection`` stage, whose
``StageTimer`` entry and profiler span cover the same interval."""

import statistics


def read(run):
    ms = [1e3 * r["timings"]["gene_selection"] for r in run["records"]
          if "gene_selection" in r.get("timings", {})]
    return statistics.median(ms) if ms else None
