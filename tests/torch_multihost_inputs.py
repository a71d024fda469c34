"""Inputs of tests/test_torch_multihost.py, made alike in the test process
and in its jobs' processes (which import only this module, numpy, scipy and
the port)."""

import numpy as np
from scipy import sparse


def solve_inputs():
    rng = np.random.RandomState(0)
    side = 48
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    X = rng.randn(5, 32)
    Y = np.abs(rng.randn(coords.shape[0], 5)) @ X \
        + 0.05 * rng.randn(coords.shape[0], 32)
    return Y, X, coords


def narrow_inputs():
    """A 48 x 4 grid: on 8 shards each holds 24 spots, half the banded
    halo (48), so a shard's window reaches two shards each side."""
    rng = np.random.RandomState(2)
    xs, ys = np.meshgrid(np.arange(48), np.arange(4))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    X = rng.randn(5, 32)
    Y = np.abs(rng.randn(coords.shape[0], 5)) @ X \
        + 0.05 * rng.randn(coords.shape[0], 32)
    return Y, X, coords


def fit_inputs():
    rng = np.random.RandomState(0)
    side = 16
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.column_stack([xs.ravel(), ys.ravel()]).astype(float)
    n = coords.shape[0]
    G, K = 400, 6
    X = rng.gamma(2.0, 1.0, size=(K, G)) * (rng.rand(K, G) < 0.3)
    bt = rng.dirichlet(np.ones(K), size=n)
    Y = sparse.csr_matrix(rng.poisson(bt @ X * 25.0).astype(np.float64))
    coords_irr = np.random.RandomState(5).rand(n, 2) * side
    return Y, X, coords, coords_irr


def gene_counts(n):
    grng = np.random.RandomState(7)
    G, K = 500, 6
    Xref = grng.gamma(2.0, 1.0, size=(K, G)) * (grng.rand(K, G) < 0.3)
    counts = sparse.random(
        n, G, density=0.1, format="csr", random_state=3,
        data_rvs=lambda k: grng.poisson(5, k).astype(np.float64) + 1.0,
    )
    return counts, Xref


def cuts(n, nproc):
    c = np.round(np.linspace(0, n, nproc + 1)).astype(int)
    c[1:-1] -= 17  # uneven slices: the variable-row all-gather
    return c


SOLVE_KW = dict(lambda_=0.3, max_iter=40, tol=1e-5)
FIT_KW = dict(sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
              tol=1e-5, random_state=0, device="cpu")
FIT_CASES = {
    "grid": dict(solver_dtype=np.float64),
    "irr": dict(solver_dtype=np.float64),
    "f32": dict(),
    "pearson": dict(solver_dtype=np.float64, preprocess="pearson"),
    "raw": dict(solver_dtype=np.float64, preprocess="raw"),
}
