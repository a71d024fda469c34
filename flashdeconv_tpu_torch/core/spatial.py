"""Graph-Laplacian utilities and spatial-regularization auto-tuning.

The port's own copy of :mod:`flashdeconv_tpu.core.spatial`, unchanged.
The device solver never materializes L: the per-sweep coordinate update
only needs neighbor sums and counts (see :mod:`flashdeconv_tpu_torch.ops.bcd`),
and the objective's Tr(beta^T L beta) term is evaluated from the same
neighbor sums. The scipy forms here serve the host API and tests.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse

# The neighbor accessors live with the rest of the graph machinery in
# utils/graph; re-exported here, as the JAX package does.
from flashdeconv_tpu_torch.utils.graph import (  # noqa: F401
    get_neighbor_counts,
    get_neighbor_indices,
)


def compute_degree_matrix(A: sparse.spmatrix) -> sparse.dia_matrix:
    """Diagonal degree matrix D with D_ii = sum_j A_ij."""
    degrees = np.asarray(A.sum(axis=1)).ravel()
    return sparse.diags(degrees, format="dia")


def compute_laplacian(
    A: sparse.spmatrix,
    normalized: bool = False,
) -> sparse.csr_matrix:
    """Graph Laplacian: L = D - A, or I - D^{-1/2} A D^{-1/2} if normalized."""
    n = A.shape[0]
    if normalized:
        degrees = np.asarray(A.sum(axis=1)).ravel()
        inv_sqrt = np.zeros_like(degrees)
        pos = degrees > 0
        inv_sqrt[pos] = 1.0 / np.sqrt(degrees[pos])
        D_inv_sqrt = sparse.diags(inv_sqrt, format="dia")
        L = sparse.eye(n) - D_inv_sqrt @ A @ D_inv_sqrt
    else:
        L = compute_degree_matrix(A) - A
    return L.tocsr()


def compute_laplacian_quadratic(beta: np.ndarray, L: sparse.spmatrix) -> float:
    """Tr(beta^T L beta) = sum over edges ||beta_i - beta_j||^2 (unnormalized L)."""
    return float(np.sum(beta * (L @ beta)))


def auto_tune_lambda(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    alpha: float = 0.005,
) -> float:
    """Scale lambda so the spatial term is ~alpha of the Hessian diagonal.

    The BCD coordinate denominator is ``XtX[k,k] + lambda * n_neighbors``; for
    the spatial prior to contribute a fraction alpha of it, set
    ``lambda = alpha * mean(diag(XtX)) / avg_neighbors``.
    """
    XtX = X_sketch @ X_sketch.T
    avg_diag = float(np.mean(np.diag(XtX)))
    avg_neighbors = float(np.mean(np.asarray(A.sum(axis=1)).ravel()))
    return float(alpha * avg_diag / max(avg_neighbors, 1.0))
