"""Mean sweeps a solve (``info["n_iterations"]``) over the window."""


def read(run):
    if not run["records"]:
        return None
    return sum(r["sweeps"] for r in run["records"]) / len(run["records"])
