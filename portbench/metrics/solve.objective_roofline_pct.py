"""The fused tier's objective kernel (``fused_banded_objective_kernel``,
one launch a solve) at its roofline, %: one pass's least time
(:func:`kernel_work.objective_bound_s`) times the window's solves, over
the device seconds of the objective kernel in the traced window; None
where the trace holds no objective kernel (the plain objective: the CPU,
f64, K above the kernel's)."""

from portbench.metrics import kernel_work


def read(run):
    w = run["work"]
    least, _ = kernel_work.objective_bound_s(w["n_spots"], w["n_types"],
                                             w["n_edges"])
    return kernel_work.share_pct(run, kernel_work.OBJECTIVE_KERNEL, least,
                                 len(run["records"]))
