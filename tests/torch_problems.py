"""Seeded numpy problems on the port's carry layouts, shared by the port's
tests. Imports no JAX and nothing of the JAX package, so the card-only
tests can use it on a machine without JAX (run them with ``--noconftest``:
tests/conftest.py imports JAX).
"""

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu_torch.ops.bcd import build_fused_rest_tables
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    banded_split,
    build_knn_graph,
    grid_coords,
)

BLOCK = 256  # small block keeps interpret mode fast; the solver uses 4096


def fused_problem(side=64, n_types=6, seed=0, block=BLOCK):
    """Numpy operands of a wholly banded grid kNN problem on the fused
    carry layout: carry (K, n + 2*h*block), Xty_t, XtX, uint8 masks, nnb."""
    coords = grid_coords(side=side)
    A = build_knn_graph(coords, k=6)
    offsets, masks, _ = banded_split(A, max_offsets=32, min_coverage=0.9)
    n = A.shape[0]
    assert n % block == 0
    h = -(-int(np.max(np.abs(offsets))) // block)
    rng = np.random.RandomState(seed)
    beta = np.abs(rng.randn(n, n_types)).astype(np.float32)
    Xs = rng.randn(n_types, 2 * n_types + 8)
    carry = np.zeros((n_types, n + 2 * h * block), np.float32)
    carry[:, h * block:h * block + n] = beta.T
    return {
        "carry": carry,
        "Xty_t": (np.abs(rng.randn(n_types, n)) * 5).astype(np.float32),
        "XtX": (Xs @ Xs.T).astype(np.float32),
        "masks": masks.astype(np.uint8),
        "nnb": masks.sum(axis=0).astype(np.float32),
        "offsets": tuple(int(o) for o in offsets),
        "h": int(h),
        "block": block,
    }


def as_torch(p, device="cpu"):
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in p.items()}


def with_rest(p, n_edges=200, seed=0):
    """``p`` (a :func:`fused_problem`) plus ``n_edges`` random symmetric
    rest edges off its bands: the padded int32 rest table ``rest_t`` (R,
    n), sentinel n, as the port's own, the fused rest stream's ``touched``
    (T,) and ``slot_cols`` (R, T) int64 tables, and the degree ``nnb`` grown by the rest edges."""
    n = p["Xty_t"].shape[1]
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, n_edges), rng.randint(0, n, n_edges)
    A_rest = (sparse.coo_matrix(
        (np.ones(2 * n_edges), (np.r_[src, dst], np.r_[dst, src])),
        shape=(n, n)).tocsr() > 0).astype(np.float64)
    table, counts = adjacency_to_padded(A_rest)
    touched, slot_cols = build_fused_rest_tables(table, n, p["h"],
                                                 p["block"])
    return dict(p, rest_t=np.ascontiguousarray(table.T.astype(np.int32)),
                touched=touched.astype(np.int64),
                slot_cols=slot_cols.astype(np.int64),
                nnb=(p["nnb"] + counts).astype(np.float32))


def dropped_grid_coords(side, frac, seed=0):
    """A side x side grid with a share ``frac`` of its bins dropped at
    random (a seeded ``RandomState``): a section whose empty or low-count
    bins were filtered out before deconvolution."""
    coords = grid_coords(side=side)
    return coords[np.random.RandomState(seed).rand(coords.shape[0]) >= frac]


def with_long_edges(A, n_edges=40, seed=0):
    """``A`` plus ``n_edges`` random long-range symmetric edges: off the
    bands of a grid graph, they make its banded decomposition keep a
    remainder (at the default 40 on a 96 x 96 grid a small one, which the
    fused tier streams; at 800 one over its 2 % gate, which takes the
    unfused banded tier)."""
    n = A.shape[0]
    rng = np.random.RandomState(seed)
    src = rng.choice(n, n_edges, replace=False)
    dst = (src + rng.randint(5_000, 8_000, size=n_edges)) % n
    extra = sparse.coo_matrix(
        (np.ones(2 * n_edges), (np.r_[src, dst], np.r_[dst, src])),
        shape=(n, n),
    )
    return ((A + extra.tocsr()) > 0).astype(np.float64)


def gather_problem(n=3000, n_types=6, seed=0):
    """Numpy operands of an irregular kNN-6 problem on the gather tier's
    (K, n) layout: beta_t, Xty_t, XtX, the neighbour table nbr_t (D, n)
    with sentinel n, and the degrees nnb."""
    rng = np.random.RandomState(seed)
    coords = rng.rand(n, 2) * np.sqrt(n)
    A = build_knn_graph(coords, k=6).tocsr()
    nbr = np.full((int(np.diff(A.indptr).max()), n), n, dtype=np.int32)
    for i in range(n):
        cols = A.indices[A.indptr[i]:A.indptr[i + 1]]
        nbr[:cols.size, i] = cols
    Xs = rng.randn(n_types, 2 * n_types + 8)
    return {
        "beta_t": np.abs(rng.randn(n_types, n)).astype(np.float32),
        "Xty_t": (np.abs(rng.randn(n_types, n)) * 5).astype(np.float32),
        "XtX": (Xs @ Xs.T).astype(np.float32),
        "nbr_t": nbr,
        "nnb": np.diff(A.indptr).astype(np.float32),
        "coords": coords,
    }
