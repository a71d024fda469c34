"""Kernel #1's panel pass (``fused_banded_sweep_panel_kernel``, the fused
tier at K > 32) at its roofline, %: a sweep's least time
(:func:`roofline.sweep_bound_s`) times the window's sweeps, over the
device seconds of the panel kernel in the traced window; None where the
trace holds no panel kernel."""

from portbench.metrics import kernel_work, roofline


def read(run):
    w = run["work"]
    least, _ = roofline.sweep_bound_s(w["n_spots"], w["n_types"],
                                      w["n_edges"])
    return kernel_work.share_pct(
        run, kernel_work.PANEL_KERNEL, least,
        sum(r["sweeps"] for r in run["records"]))
