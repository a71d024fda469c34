"""Seeded numpy problems on the fused carry layout, shared by the port's
tests. Imports no JAX, so the card-only tests can use it on a machine
without JAX (run them with ``--noconftest``: tests/conftest.py imports JAX).
"""

import numpy as np
import torch

import flashdeconv_tpu_torch  # noqa: F401  (keeps flashdeconv_tpu off JAX)
from flashdeconv_tpu.utils.graph import banded_split, build_knn_graph, grid_coords

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


