"""Spots fitted per second: all spots of all fits of the window over the
window's time (from its opening to the end of its last fit)."""


def read(run):
    if not run["records"]:
        return None
    return sum(r["spots"] for r in run["records"]) / run["window_s"]
