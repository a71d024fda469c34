"""Set-up seconds: from the start of the run to the window's opening
(imports, inputs, the program's prepare, the warm-up call and, in a fresh
checkout, the kernels' build)."""


def read(run):
    return run["setup_s"]
