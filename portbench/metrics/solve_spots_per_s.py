"""Spots solved per second: all spots of all solves of the window over the
window's time (from its opening to the end of its last solve)."""


def read(run):
    if not run["records"]:
        return None
    return sum(r["spots"] for r in run["records"]) / run["window_s"]
