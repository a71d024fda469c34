"""Peaks of one NVIDIA H100 (SXM, dense, at its 700 W limit) and the work
of one solve sweep, counted from the shapes and the graph.

A frozen, extended copy of ``chip_smoke.bound_ms`` / ``gs_ops``: a sweep,
whatever kernels implement it, must read the carry (K x n), Xty (K x n),
XtX (K x K) and the graph's neighbour indices (one int32 per stored edge)
once each, and write the new carry once; its float32 operations are the
Gauss-Seidel pass's (``gs_ops``) plus K additions per stored edge for the
neighbour sums. The least time is the larger of the bytes over the HBM
bandwidth and the operations over the float32 (non-tensor) peak.
"""

from __future__ import annotations

#: HBM3 bandwidth of the H100 SXM, bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: Float32 peak outside the tensor cores, operations/s (data sheet).
F32_OPS_PER_S = 67e12
F32_BYTES = 4
INDEX_BYTES = 4


def gs_ops(K: int, n: int) -> float:
    """Float32 operations of the Gauss-Seidel pass over n spots: the
    XtX @ beta product (2K^2), the rank-1 refreshes (K(K-1)) and about 8
    per coordinate (numerator, clamp, scale, difference)."""
    return n * (2.0 * K * K + K * (K - 1) + 8.0 * K)


def sweep_bytes(n: int, K: int, n_edges: int) -> float:
    """Bytes a sweep must move: carry in, Xty, XtX, the neighbour indices,
    carry out."""
    return (F32_BYTES * (3.0 * K * n + K * K)
            + INDEX_BYTES * float(n_edges))


def sweep_ops(n: int, K: int, n_edges: int) -> float:
    """Float32 operations of a sweep: the pass and the neighbour sums."""
    return gs_ops(K, n) + float(K) * n_edges


def bound_s(n_bytes: float, n_ops: float):
    """The least time the card could take: (seconds, "bytes" or
    "operations")."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def sweep_bound_s(n: int, K: int, n_edges: int):
    return bound_s(sweep_bytes(n, K, n_edges), sweep_ops(n, K, n_edges))
