"""Plain reference of ``FlashDeconv.fit`` on CSR counts with the
configurations' settings (``preprocess="log_cpm"``, kNN graph, sparse
counts), in NumPy and SciPy on the host and PyTorch for the solve.

The stages are FlashDeconv v0.1.6's, frozen here as plain code:

1. gene selection: the top ``n_hvg`` genes by binned dispersion of
   log1p(1e4 * counts / library) (Seurat-v3-style, 20 mean bins), united
   with ``n_markers_per_type`` markers a type ("diff" score of the
   row-normalised signatures), and the leverage scores of the selected
   signatures;
2. preprocessing: log1p(1e4 * counts / library) of the selected genes (the
   library over the selected genes, 0 read as 1), log1p(1e4 * X / (row sum
   + 1e-10)) of the signatures;
3. the leverage-weighted CountSketch of the selected genes from
   ``numpy.random.RandomState(random_state)``;
4. the symmetrised kNN graph of the coordinates;
5. lambda = 0.005 * mean(diag(XtX)) / max(mean degree, 1) for "auto";
6. the solve of :mod:`portbench.reference.solve`;
7. proportions: beta over its row sums, an all-zero row uniform.

Library sizes and the HVG moments take the counts' own dtype for the
per-entry values (float32 counts give float32 log1p values) with float64
sums, as FlashDeconv's sparse path does, so that the gene ranking sees the
same numbers; everything after gene selection is float64 (or the TF32
control of :mod:`portbench.reference.solve`). Imports nothing of the
program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy import sparse

from portbench import inputs
from portbench.reference import solve as ref_solve

N_DISPERSION_BINS = 20


def library_scale(Y: sparse.csr_matrix) -> np.ndarray:
    """1e4 / max(row sum, 1), in the data's dtype (row sums of integer
    counts are exact in float32 below 2**24)."""
    lib = np.asarray(Y.sum(axis=1, dtype=np.float64)).ravel()
    return (1e4 / np.maximum(lib, 1.0)).astype(Y.data.dtype)


def hvg_moments(Y: sparse.csr_matrix, block: int = 1 << 16):
    """Per-gene mean and sample variance of log1p(1e4 * counts / library)
    over all bins (implicit zeros included)."""
    n, G = Y.shape
    scale = library_scale(Y)
    s1, s2 = np.zeros(G), np.zeros(G)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        lo, hi = Y.indptr[r0], Y.indptr[r1]
        v = np.log1p(Y.data[lo:hi] * np.repeat(scale[r0:r1],
                                               np.diff(Y.indptr[r0:r1 + 1])))
        cols = Y.indices[lo:hi]
        s1 += np.bincount(cols, weights=v, minlength=G)
        s2 += np.bincount(cols, weights=v.astype(np.float64) ** 2,
                          minlength=G)
    means = s1 / n
    var = np.maximum(n / (n - 1) * (s2 / n - means ** 2), 0.0)
    return means, var


def binned_dispersion(means, variances):
    dispersion = np.zeros(means.shape[0])
    positive = means[means > 0]
    if positive.size < 2:
        return dispersion
    edges = np.unique(np.percentile(
        positive, np.linspace(0, 100, N_DISPERSION_BINS + 1)))
    if edges.size < 2:
        return dispersion
    bin_of = np.clip(np.digitize(means, edges) - 1, 0, edges.size - 2)
    for b in range(edges.size - 1):
        members = bin_of == b
        if members.sum() > 1:
            v = variances[members]
            dispersion[members] = (v - v.mean()) / (v.std() + 1e-10)
    return dispersion


def select_hvg(Y, n_top, min_mean=0.0125, max_mean=3.0, min_disp=0.5):
    means, variances = hvg_moments(Y)
    dispersion = binned_dispersion(means, variances)
    valid = np.flatnonzero((means >= min_mean) & (means <= max_mean)
                           & (dispersion >= min_disp))
    if valid.size < n_top:
        chosen = np.argsort(dispersion)[::-1][:n_top]
    else:
        chosen = valid[np.argsort(dispersion[valid])[::-1][:n_top]]
    return np.sort(chosen)


def select_markers(X, n_markers):
    K, G = X.shape
    if n_markers == 0:
        return np.array([], dtype=np.intp)
    Xn = X / (X.sum(axis=1, keepdims=True) + 1e-10)
    if K == 1:
        return np.arange(min(n_markers, G))
    top = Xn.max(axis=0)
    score = top - np.partition(Xn, -2, axis=0)[-2]
    owner = np.argmax(Xn, axis=0)
    markers = []
    for k in range(K):
        owned = np.flatnonzero(owner == k)
        if owned.size:
            markers.extend(owned[np.argsort(score[owned])[::-1][:n_markers]])
        else:
            markers.extend(np.argsort(Xn[k])[::-1][:n_markers])
    return np.unique(markers)


def leverage_scores(X, reg=1e-6):
    Xc = X - X.mean(axis=0, keepdims=True)
    U, s, _ = np.linalg.svd(Xc.T, full_matrices=False)
    k = min(X.shape[0], X.shape[1], s.size)
    lev = (U[:, :k] ** 2) @ (s[:k] ** 2 / (s[:k] ** 2 + reg))
    return lev / (lev.sum() + reg)


def countsketch(n_genes, d, leverage, random_state):
    """(buckets, weights) of the leverage-weighted CountSketch."""
    rng = np.random.RandomState(random_state)
    lev = leverage / (np.sum(leverage) + 1e-10)
    buckets = rng.randint(0, d, size=n_genes)
    signs = rng.choice([-1, 1], size=n_genes)
    entries = signs * np.clip(np.sqrt(lev * n_genes + 1e-10), 0.1, 10.0)
    norms = np.maximum(np.sqrt(np.bincount(buckets, weights=entries ** 2,
                                           minlength=d)), 1e-10)
    return buckets, entries * (np.sqrt(n_genes / d) / norms[buckets])


def sketch_counts(Y, genes, buckets, weights, d, block: int = 1 << 15):
    """Y_sketch (n, d) f64 = log1p(1e4 * Y_sel / library_sel) @ Omega,
    Omega[g, buckets[g]] = weights[g], in row blocks."""
    n, G = Y.shape
    pos = np.full(G, -1, dtype=np.int64)
    pos[genes] = np.arange(genes.size)
    out = np.empty((n, d))
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        lo, hi = Y.indptr[r0], Y.indptr[r1]
        p = pos[Y.indices[lo:hi]]
        row = np.repeat(np.arange(r1 - r0), np.diff(Y.indptr[r0:r1 + 1]))
        keep = p >= 0
        v, p, row = Y.data[lo:hi][keep].astype(np.float64), p[keep], row[keep]
        lib = np.bincount(row, weights=v, minlength=r1 - r0)
        lib[lib == 0] = 1.0
        val = np.log1p(v * (1e4 / lib)[row])
        out[r0:r1] = np.bincount(row * d + buckets[p], weights=val * weights[p],
                                 minlength=(r1 - r0) * d).reshape(r1 - r0, d)
    return out


class FitReference(NamedTuple):
    gene_idx: np.ndarray
    adjacency: sparse.csr_matrix
    lambda_: float
    solution: ref_solve.Solution
    proportions: torch.Tensor


def fit(Y: sparse.csr_matrix, X: np.ndarray, coords: np.ndarray,
        params: dict, device, precision: str = "f64") -> FitReference:
    """The whole fit of ``params`` (FlashDeconv's keyword arguments) on
    CSR counts ``Y`` (n, G), signatures ``X`` (K, G) and ``coords``."""
    if params.get("preprocess", "log_cpm") != "log_cpm" or \
            params.get("spatial_method", "knn") != "knn":
        raise ValueError("the reference covers log_cpm with a kNN graph")
    Y = sparse.csr_matrix(Y)
    X = np.asarray(X, dtype=np.float64)
    genes = np.union1d(select_hvg(Y, int(params["n_hvg"])),
                       select_markers(X, int(params["n_markers_per_type"]))
                       ).astype(np.intp)
    Xs = X[:, genes]
    lev = leverage_scores(Xs)
    X_tilde = np.log1p(Xs / (Xs.sum(axis=1, keepdims=True) + 1e-10) * 1e4)
    d = int(params["sketch_dim"])
    buckets, weights = countsketch(genes.size, d, lev,
                                   int(params["random_state"]))
    omega = sparse.csr_matrix((weights, (np.arange(genes.size), buckets)),
                              shape=(genes.size, d))
    X_sketch = np.asarray(X_tilde @ omega)
    Y_sketch = sketch_counts(Y, genes, buckets, weights, d)
    A = inputs.knn_graph(np.asarray(coords), int(params["k_neighbors"]))
    XtX = X_sketch @ X_sketch.T
    lam = params["lambda_spatial"]
    if lam == "auto":
        deg = float(np.mean(np.diff(A.indptr)))
        lam = 0.005 * float(np.mean(np.diag(XtX))) / max(deg, 1.0)
    lam = float(lam)
    Xty = ref_solve.xty_from_sketch(Y_sketch, X_sketch, precision, device)
    del Y_sketch
    sol = ref_solve.bcd(Xty, XtX, A, lam, float(params["rho_sparsity"]),
                        float(params["tol"]), int(params["max_iter"]),
                        precision)
    return FitReference(genes, A, lam, sol, ref_solve.normalize(sol.beta))
