"""Per-kernel roofline shares from the device trace: the least time of one
kernel's work, counted from the section's shapes, over the device seconds
of the trace's operations that carry the kernel's name.

Two kernels of the fused banded tier:

- the sweep's panel pass, ``fused_banded_sweep_panel_kernel`` (K > 32):
  one launch a sweep, whose work is :func:`roofline.sweep_bound_s`'s;
- the objective, ``fused_banded_objective_kernel``: one launch a solve. It
  must read the carry (K x n), Xty (K x n), the spots' degrees (one f32 a
  spot), XtX (K x K) and the band masks, counted at one uint8 entry a
  stored edge (the least a band mask can hold the graph in: a mask has one
  set entry for each stored edge, and its clear entries are the layout's,
  not the graph's), and writes next to nothing. Its float32 operations
  are the five sums a spot: cross, the squares for the degree term and the
  adjacency sum 2K each, the L1 sum K, the degree's one multiply, the
  quadratic form 2K^2 + 2K; and the neighbour sums, K additions a stored
  edge.

A share is None where the trace holds no operation of the kernel's name
(another tier or K, a program without the kernel, an untraced run).
"""

from __future__ import annotations

from typing import Optional

from portbench.metrics import roofline

PANEL_KERNEL = "fused_banded_sweep_panel_kernel"
OBJECTIVE_KERNEL = "fused_banded_objective_kernel"
MASK_BYTES = 1


def objective_bytes(n: int, K: int, n_edges: int) -> float:
    """Bytes one objective pass must read: carry, Xty, degrees, XtX, one
    mask entry a stored edge."""
    return (roofline.F32_BYTES * (2.0 * K * n + n + K * K)
            + MASK_BYTES * float(n_edges))


def objective_ops(n: int, K: int, n_edges: int) -> float:
    """Float32 operations of one objective pass: the five sums a spot
    (2K^2 + 9K + 1) and K neighbour-sum additions a stored edge."""
    return n * (2.0 * K * K + 9.0 * K + 1.0) + float(K) * n_edges


def objective_bound_s(n: int, K: int, n_edges: int):
    """The least time of one objective pass: (seconds, "bytes" or
    "operations")."""
    return roofline.bound_s(objective_bytes(n, K, n_edges),
                            objective_ops(n, K, n_edges))


def device_s(trace: Optional[dict], kernel: str) -> Optional[float]:
    """Device seconds of the trace's operations whose name holds
    ``kernel``; None without a trace or without such an operation."""
    if not trace:
        return None
    total = sum(s for name, s in trace.get("device_ops", ()) if kernel in name)
    return total if total > 0 else None


def share_pct(run: dict, kernel: str, least_s: float,
              launches: int) -> Optional[float]:
    """100 x ``least_s`` x ``launches`` over the device seconds of
    ``kernel`` in the run's trace; None where the trace lacks it."""
    busy = device_s(run.get("trace"), kernel)
    if busy is None or not launches:
        return None
    return 100.0 * least_s * launches / busy
