"""Normalisation of spatial counts and reference signatures.

The port's own copy of the preprocessing helpers of
:mod:`flashdeconv_tpu.core.deconv`; the code is unchanged apart from its
imports.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from scipy import sparse

ArrayLike = Union[np.ndarray, sparse.spmatrix]

_PREPROCESS_METHODS = ("log_cpm", "pearson", "raw")


def _log_cpm_dense(X: np.ndarray) -> np.ndarray:
    """Dense log1p(CPM*1e4) with the signature-matrix epsilon convention."""
    Xd = np.asarray(X, dtype=np.float64)
    return np.log1p(Xd / (Xd.sum(axis=1, keepdims=True) + 1e-10) * 1e4)


#: NB overdispersion for the pearson-residual preprocess (reference
#: flashdeconv/core/deconv.py:199-225 hard-codes theta=100).
_PEARSON_THETA = 100.0


def _pearson_sigma(mu: np.ndarray) -> np.ndarray:
    """NB standard deviation sqrt(mu + mu^2/theta) in mu's dtype — the ONE
    home of the formula so the staged and fused pearson paths cannot
    drift."""
    return np.sqrt(mu + mu**2 / _PEARSON_THETA)


def _pearson_dense(X: np.ndarray) -> np.ndarray:
    """Dense uncentered Pearson residuals (the signature-matrix branch)."""
    Xd = np.asarray(X, dtype=np.float64)
    mu_x = Xd.mean(axis=0, keepdims=True) + 1e-6
    return Xd / _pearson_sigma(mu_x)


def _zero_poisoned_csr_rows(Y, gene_idx: np.ndarray, logcpm: bool = False):
    """Rows of CSR ``Y`` whose *selected* gene entries poison the fused
    feed, zeroed in a data-only copy; None when nothing needs repair.

    Support for the fused-feed degraded path: the native pass reduces YtY
    over the raw sketch, so one poisoned count makes the objective
    constant non-finite even though the solver's row guard keeps beta
    finite. Poison = a non-finite entry, or — on the log_cpm path
    (``logcpm=True``) — a finite entry whose log1p(v * 1e4/lib) is
    non-finite (``v * scale <= -1``; ``lib`` = the row's SELECTED-gene
    sum with the staged path's lib==0 -> 1 rule, so the exact rows the
    staged pipeline's sketch-level guard would zero). A poisoned log_cpm
    row necessarily contains a negative or non-finite selected entry
    (all-nonnegative-finite rows give scale > 0 and v*scale >= 0), so
    candidates are found cheaply and verified exactly per row.
    Only selected columns matter — the fused kernels subset genes before
    the library-size/normalize/sketch passes (reference
    ``flashdeconv/core/deconv.py:321-330`` subsets first too). The whole
    poisoned row is zeroed (not just the bad entry) to match the solver
    guard's zero-observation semantics.
    """
    sel = np.zeros(Y.shape[1], dtype=bool)
    sel[np.asarray(gene_idx)] = True
    data = Y.data
    cand_entry = ~np.isfinite(data)
    if logcpm:
        cand_entry |= data < 0
    cand_pos = np.flatnonzero(cand_entry)
    if cand_pos.size:
        cand_pos = cand_pos[sel[Y.indices[cand_pos]]]
    if cand_pos.size == 0:
        return None
    cand_rows = np.unique(
        np.searchsorted(Y.indptr, cand_pos, side="right") - 1
    )
    bad_rows = []
    for r in cand_rows:
        lo, hi = Y.indptr[r], Y.indptr[r + 1]
        v = data[lo:hi][sel[Y.indices[lo:hi]]]
        if not np.isfinite(v).all():
            bad_rows.append(r)
            continue
        if logcpm:
            lib = float(v.sum())
            if lib == 0.0:
                lib = 1.0
            if np.any(v * (1e4 / lib) <= -1.0):
                bad_rows.append(r)
    if not bad_rows:
        return None
    data = data.copy()
    for r in bad_rows:
        data[Y.indptr[r]: Y.indptr[r + 1]] = 0.0
    return sparse.csr_matrix((data, Y.indices, Y.indptr), shape=Y.shape)


def preprocess_data(
    Y: ArrayLike,
    X: np.ndarray,
    method: str = "log_cpm",
) -> Tuple[ArrayLike, np.ndarray]:
    """Normalize spatial counts Y and signatures X.

    Methods
    -------
    log_cpm : log1p(counts-per-10k). Sparse Y keeps its sparsity pattern
        (log1p(0)=0): only the ``.data`` values change, returned as a new
        CSR matrix; the input is never modified.
    pearson : uncentered Pearson residuals y / sigma with the NB variance
        model sigma^2 = mu + mu^2/theta (theta=100); keeps values >= 0.
    raw : float cast only.
    """
    if method == "log_cpm":
        if sparse.issparse(Y):
            from flashdeconv_tpu_torch import native

            Ycsr = Y.tocsr() if not sparse.isspmatrix_csr(Y) else Y
            lib = native.csr_row_sums(Ycsr)
            if lib is None:
                lib = np.asarray(Ycsr.sum(axis=1)).ravel()
            lib[lib == 0] = 1.0
            # Direct per-nnz transform: avoids the diagonal matmul (which
            # dominates at atlas-scale nnz). Index arrays are copied so the
            # returned matrix never aliases the caller's buffers (an
            # in-place structural op like sort_indices() on the result must
            # not corrupt the input). Native kernel when available
            # (threaded, element-wise; <= 1 ULP of the numpy expression —
            # see native.exact_log1p_available); numpy otherwise.
            # scale dtype follows numpy promotion: f32 data keeps the f32
            # library sizes (scipy's .sum semantics), anything else is f64.
            scale = 1e4 / np.asarray(lib, dtype=np.float64) \
                if Ycsr.data.dtype != np.float32 else 1e4 / lib.astype(
                    np.float32, copy=False)
            new_data = native.log1p_cpm_transform(Ycsr, scale)
            if new_data is None:
                counts = np.diff(Ycsr.indptr)
                new_data = np.log1p(Ycsr.data * np.repeat(scale, counts))
            Y_norm = sparse.csr_matrix(
                (new_data, Ycsr.indices.copy(), Ycsr.indptr.copy()),
                shape=Ycsr.shape, copy=False,
            )
        else:
            Yd = np.asarray(Y, dtype=np.float64)
            Y_norm = np.log1p(Yd / (Yd.sum(axis=1, keepdims=True) + 1e-10) * 1e4)
        return Y_norm, _log_cpm_dense(X)

    if method == "pearson":
        if sparse.issparse(Y):
            mu = np.asarray(Y.mean(axis=0)).ravel() + 1e-6
            Y_norm = Y.multiply(1.0 / _pearson_sigma(mu)).tocsr()
        else:
            Yd = np.asarray(Y, dtype=np.float64)
            mu = Yd.mean(axis=0, keepdims=True) + 1e-6
            Y_norm = Yd / _pearson_sigma(mu)
        return Y_norm, _pearson_dense(X)

    if method == "raw":
        return Y.astype(np.float64, copy=False), X.astype(np.float64, copy=False)

    raise ValueError(
        f"Unknown preprocess method: {method}. "
        f"Choose from 'log_cpm', 'pearson', or 'raw'."
    )
