"""A sweep's least time over its measured device time, %.

The least time is :func:`roofline.sweep_bound_s` of the section's spots,
types and stored graph edges; the measured time is the device's busy time
inside the traced window (every kernel, copy and fill, overlaps counted
once) over the sweeps of the window's solves."""

from portbench.metrics import roofline


def read(run):
    trace = run.get("trace")
    sweeps = sum(r["sweeps"] for r in run["records"])
    if not trace or not trace["busy_s"] or not sweeps:
        return None
    w = run["work"]
    least, _ = roofline.sweep_bound_s(w["n_spots"], w["n_types"],
                                      w["n_edges"])
    return 100.0 * least / (trace["busy_s"] / sweeps)
