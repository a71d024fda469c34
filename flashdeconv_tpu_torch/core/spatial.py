"""Spatial-regularization auto-tuning.

The port's own copy of
:func:`flashdeconv_tpu.core.spatial.auto_tune_lambda`, unchanged.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


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
