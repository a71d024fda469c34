"""Informative-gene selection and leverage scoring.

The port's own copy of :mod:`flashdeconv_tpu.utils.genes`; the code is
unchanged apart from its imports.

Host-side, one-shot O(nnz) feature engineering that runs before any device
work: highly-variable-gene (HVG) selection on the spatial counts, per-type
marker selection on the reference signatures, and SVD leverage scores that
weight the CountSketch amplitudes.

Behavioral parity targets (reference ``flashdeconv/utils/genes.py``):
* ``select_hvg``             — Seurat-v3-style binned dispersion (ref :18-145)
* ``select_markers``         — diff / ratio / specificity scores (ref :148-235)
* ``compute_leverage_scores``— PC-weighted row norms of U        (ref :238-290)
* ``select_informative_genes`` — HVG ∪ markers + leverage        (ref :293-341)

These stay in numpy: they are O(nnz) single-pass reductions over a sparse
matrix that is never materialized on device (the device only ever sees the
sketched N x d panel), so there is nothing for the MXU to accelerate here.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
from scipy import sparse

ArrayLike = Union[np.ndarray, sparse.spmatrix]

_N_DISPERSION_BINS = 20


def moments_from_sums(
    col_sum: np.ndarray, col_sumsq: np.ndarray, n_spots: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, sample variance) from additive column sums.

    The sums are additive over disjoint spot slices, which is what makes the
    multi-host gene-selection reduction possible
    (:func:`flashdeconv_tpu.parallel.multihost.distributed_gene_moments`):
    each host computes sums for its rows, the sums are all-reduced, and
    every host derives identical moments.
    """
    n_genes = col_sum.shape[0]
    means = col_sum / n_spots
    if n_spots >= 2:
        variances = n_spots / (n_spots - 1) * (col_sumsq / n_spots - means**2)
        variances = np.maximum(variances, 0.0)
    else:
        variances = np.zeros(n_genes)
    return means, variances


def log1p_cpm_sums(Y: ArrayLike) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene sum and sum-of-squares of log1p(CPM*1e4) over sparse rows.

    The additive half of the HVG moments (see :func:`moments_from_sums`);
    sparse-path numerics (f32 data -> f32 intermediates, f64 accumulation).
    """
    Ycsr = Y.tocsr() if not sparse.isspmatrix_csr(Y) else Y

    # Fully fused native pass (library sizes + moments in one O(nnz)
    # sweep); bit-identical to the staged computation below.
    from flashdeconv_tpu_torch import native

    fused = native.log1p_cpm_moments_auto(Ycsr)
    if fused is not None:
        return fused

    lib = _csr_row_sums(Ycsr)
    lib = np.maximum(lib, 1.0)
    scale = 1e4 / lib
    return _log1p_cpm_sums_impl(Ycsr, scale)


def _csr_row_sums(Ycsr: sparse.csr_matrix) -> np.ndarray:
    """Row sums of a CSR matrix (library sizes) — threaded native kernel
    when available (bit-identical to scipy's ``.sum(axis=1)``; rows are
    independent, see ``native/host_kernels.cpp``), scipy otherwise."""
    from flashdeconv_tpu_torch import native

    sums = native.csr_row_sums(Ycsr)
    if sums is None:
        sums = np.asarray(Ycsr.sum(axis=1)).ravel()
    return sums


def _log1p_cpm_sums_impl(
    Ycsr: sparse.csr_matrix, scale: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Column sums of log1p(data * scale[row]) and its square, f64.

    Native fused pass when available (C++,
    ``flashdeconv_tpu_torch/native/host_kernels.cpp``): one
    scale->log1p->accumulate sweep over the nnz instead of four materialized
    temporaries + two bincounts per block; ~20x the numpy throughput at
    atlas scale. The kernel mirrors this function's dtype semantics (f64
    data -> f64 intermediates; f32 data -> f32 intermediates with f64
    accumulation). Results are ULP-level equivalent — not bitwise — to this
    numpy path: the native block size adapts to the row count (different
    f64 association order) and the f32 path uses a vectorized log1p (<= 1
    ULP of correctly-rounded). The only consumer is rank-based HVG
    selection, which both paths' tests pin to identical gene indices.
    """
    n_spots, n_genes = Ycsr.shape

    from flashdeconv_tpu_torch import native

    if Ycsr.data.dtype in (np.float32, np.float64):
        native_sums = native.log1p_cpm_moments(Ycsr, scale)
        if native_sums is not None:
            return native_sums

    # Numpy fallback: stream row blocks so per-nnz temporaries stay
    # cache-sized and the matrix is never copied (atlas-scale nnz can be
    # ~1e9). Blocks run on a small thread pool — log1p / multiply /
    # bincount release the GIL, so this scales with cores.
    indptr, indices, data = Ycsr.indptr, Ycsr.indices, Ycsr.data
    block = 65536

    def _block_sums(r0: int):
        r1 = min(r0 + block, n_spots)
        lo, hi = indptr[r0], indptr[r1]
        counts = np.diff(indptr[r0 : r1 + 1])
        vals = np.log1p(data[lo:hi] * np.repeat(scale[r0:r1], counts))
        cols = indices[lo:hi]
        return (
            np.bincount(cols, weights=vals, minlength=n_genes),
            np.bincount(cols, weights=vals**2, minlength=n_genes),
        )

    starts = range(0, n_spots, block)
    col_sum = np.zeros(n_genes)
    col_sumsq = np.zeros(n_genes)
    if n_spots > 4 * block:
        import concurrent.futures as cf
        import os

        workers = min(4, os.cpu_count() or 1)
        with cf.ThreadPoolExecutor(workers) as pool:
            for s, sq in pool.map(_block_sums, starts):
                col_sum += s
                col_sumsq += sq
    else:
        for s, sq in map(_block_sums, starts):
            col_sum += s
            col_sumsq += sq
    return col_sum, col_sumsq


def _log1p_cpm_moments(Y: ArrayLike) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene mean and sample variance of log1p(CPM*1e4) counts.

    Sparse inputs are handled without densifying: row scaling is applied to
    the CSR ``.data`` buffer and the column moments come from ``bincount``
    reductions over the nnz entries (log1p(0) == 0 keeps zeros implicit).
    """
    n_spots, n_genes = Y.shape

    if sparse.issparse(Y):
        col_sum, col_sumsq = log1p_cpm_sums(Y)
        return moments_from_sums(col_sum, col_sumsq, n_spots)

    Yd = np.asarray(Y, dtype=np.float64)
    lib = np.maximum(Yd.sum(axis=1, keepdims=True), 1.0)
    Ylog = np.log1p(Yd / lib * 1e4)
    means = Ylog.mean(axis=0)
    variances = Ylog.var(axis=0, ddof=1) if n_spots >= 2 else np.zeros(n_genes)
    return means, variances


def _binned_dispersion(means: np.ndarray, variances: np.ndarray) -> np.ndarray:
    """Standardize per-gene variance within mean-expression percentile bins."""
    n_genes = means.shape[0]
    dispersion = np.zeros(n_genes)
    positive = means[means > 0]
    if positive.size < 2:
        return dispersion

    edges = np.unique(
        np.percentile(positive, np.linspace(0, 100, _N_DISPERSION_BINS + 1))
    )
    if edges.size < 2:
        return dispersion

    bin_of = np.clip(np.digitize(means, edges) - 1, 0, edges.size - 2)
    for b in range(edges.size - 1):
        members = bin_of == b
        if members.sum() > 1:
            v = variances[members]
            dispersion[members] = (v - v.mean()) / (v.std() + 1e-10)
    return dispersion


def select_hvg(
    Y: ArrayLike,
    n_top: int = 2000,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
) -> np.ndarray:
    """Select highly variable genes (Seurat-v3-style binned dispersion).

    Parameters
    ----------
    Y : (n_spots, n_genes) array or sparse matrix
        Raw counts.
    n_top : int
        Number of HVGs to return.
    min_mean, max_mean, min_disp : float
        Mean-expression window and dispersion floor for the valid-gene filter.

    Returns
    -------
    (n_hvg,) int array of sorted gene indices.
    """
    means, variances = _log1p_cpm_moments(Y)
    return hvg_from_moments(
        means, variances, n_top=n_top, min_mean=min_mean, max_mean=max_mean,
        min_disp=min_disp,
    )


def hvg_from_moments(
    means: np.ndarray,
    variances: np.ndarray,
    n_top: int = 2000,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
) -> np.ndarray:
    """HVG ranking/filtering given precomputed per-gene moments.

    Split out of :func:`select_hvg` so the multi-host path
    (:func:`flashdeconv_tpu.parallel.multihost.distributed_gene_moments`)
    applies the identical selection rule to its all-reduced moments.
    """
    dispersion = _binned_dispersion(means, variances)

    valid = np.flatnonzero(
        (means >= min_mean) & (means <= max_mean) & (dispersion >= min_disp)
    )
    if valid.size < n_top:
        # Not enough genes pass the filters: rank every gene by dispersion.
        chosen = np.argsort(dispersion)[::-1][:n_top]
    else:
        order = np.argsort(dispersion[valid])[::-1][:n_top]
        chosen = valid[order]
    return np.sort(chosen)


def select_markers(
    X: np.ndarray,
    n_markers: int = 50,
    method: str = "diff",
) -> Tuple[np.ndarray, np.ndarray]:
    """Select cell-type-specific marker genes from the signature matrix.

    Each gene is "owned" by the cell type with its highest row-normalized
    expression; within each type's owned genes the top ``n_markers`` by a
    specificity score are kept.

    Parameters
    ----------
    X : (n_cell_types, n_genes) ndarray
    n_markers : int
        Markers per cell type.
    method : {"diff", "ratio", "specificity"}
        diff  — top expression minus runner-up;
        ratio — top expression over mean of the others;
        specificity — tau score.

    Returns
    -------
    marker_idx : int array (union of all types' markers, unique-sorted)
    marker_assignments : int array, owning type per selected marker (pre-union)
    """
    n_types, n_genes = X.shape
    if n_markers < 0:
        raise ValueError(f"n_markers must be non-negative, got {n_markers}")
    if n_markers == 0 or n_types == 0:
        return np.array([], dtype=np.intp), np.array([], dtype=np.intp)

    Xn = X / (X.sum(axis=1, keepdims=True) + 1e-10)

    if n_types == 1:
        idx = np.arange(min(n_markers, n_genes))
        return idx, np.zeros(idx.size, dtype=np.intp)

    top = np.max(Xn, axis=0)
    if method == "diff":
        runner_up = np.partition(Xn, -2, axis=0)[-2]
        score = top - runner_up
    elif method == "ratio":
        score = top / ((Xn.sum(axis=0) - top) / (n_types - 1) + 1e-10)
    elif method == "specificity":
        score = np.sum(1.0 - Xn / (top + 1e-10), axis=0) / (n_types - 1)
    else:
        raise ValueError(f"Unknown method: {method}")

    owner = np.argmax(Xn, axis=0)
    markers, assignments = [], []
    for k in range(n_types):
        owned = np.flatnonzero(owner == k)
        if owned.size > 0:
            picked = owned[np.argsort(score[owned])[::-1][:n_markers]]
        else:
            # Type owns no gene: fall back to its highest-expression genes.
            picked = np.argsort(Xn[k])[::-1][:n_markers]
        markers.extend(picked)
        assignments.extend([k] * len(picked))

    return np.unique(markers), np.asarray(assignments, dtype=np.intp)


def compute_leverage_scores(
    X: np.ndarray,
    regularization: float = 1e-6,
) -> np.ndarray:
    """Per-gene leverage scores from the SVD of the centered signature matrix.

    The reference matrix is centered across cell types and decomposed as
    ``X_centered.T = U S Vt`` (genes x types); each gene's leverage is the
    squared-loading sum over principal components, weighted by
    ``s^2 / (s^2 + reg)``, normalized to a probability vector.

    Falls back to normalized per-gene variance if the SVD fails to converge.
    """
    Xc = X - X.mean(axis=0, keepdims=True)
    try:
        U, s, _ = np.linalg.svd(Xc.T, full_matrices=False)
    except np.linalg.LinAlgError:
        var = np.var(X, axis=0)
        return var / (var.sum() + regularization)

    k = min(X.shape[0], X.shape[1], s.size)
    pc_weight = s[:k] ** 2 / (s[:k] ** 2 + regularization)
    leverage = (U[:, :k] ** 2) @ pc_weight
    return leverage / (leverage.sum() + regularization)


def select_informative_genes(
    Y: ArrayLike,
    X: np.ndarray,
    n_hvg: int = 2000,
    n_markers_per_type: int = 50,
) -> Tuple[np.ndarray, np.ndarray]:
    """Union of spatial HVGs and reference markers, with leverage scores.

    Returns
    -------
    gene_idx : int array of selected gene indices (sorted, unique)
    leverage_scores : float array over the selected genes (sums to ~1)
    """
    hvg_idx = select_hvg(Y, n_top=n_hvg)
    marker_idx, _ = select_markers(X, n_markers=n_markers_per_type)
    gene_idx = np.union1d(hvg_idx, marker_idx).astype(np.intp)
    if gene_idx.size == 0:
        raise ValueError("No genes selected. Increase n_hvg or n_markers_per_type.")
    return gene_idx, compute_leverage_scores(X[:, gene_idx])
