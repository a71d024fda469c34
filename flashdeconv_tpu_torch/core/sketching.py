"""Leverage-weighted CountSketch compression of the gene axis (G -> d).

The port's own copy of :mod:`flashdeconv_tpu.core.sketching`, holding the
operator and the host projection. The device projection (the JAX
package's Pallas CountSketch kernel) is not ported yet: ``backend="device"``
raises ``NotImplementedError``.

The sketch operator is constructed **host-side with numpy's MT19937** so a
given integer seed draws the identical bucket/sign/amplitude sequence as the
reference implementation (reference ``flashdeconv/core/sketching.py:48-84``) —
sketch-operator parity is a prerequisite for output parity on the reference
test scenarios.

The *projection* Y @ Omega runs on the host: the native CSR scatter, or a
scipy sparse matmul, O(nnz) — sparse spatial counts never need to be
densified (only the dense N x d sketch ever reaches the device).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
from scipy import sparse

from flashdeconv_tpu_torch.utils.random import (
    RandomStateLike,
    check_random_state,
)

ArrayLike = Union[np.ndarray, sparse.spmatrix]


@dataclass(frozen=True)
class CountSketchOp:
    """Device-friendly CountSketch parameters: one (bucket, weight) per gene.

    ``Omega[g, buckets[g]] = weights[g]`` and all other entries are zero, so
    the projection is ``out[:, buckets[g]] += weights[g] * Y[:, g]``.
    """

    buckets: np.ndarray  # (n_genes,) int32 in [0, sketch_dim)
    weights: np.ndarray  # (n_genes,) float64: sign * amplitude * column scale
    sketch_dim: int

    @property
    def n_genes(self) -> int:
        return self.buckets.shape[0]

    def to_csr(self) -> sparse.csr_matrix:
        """Materialize as a scipy CSR matrix (n_genes x sketch_dim)."""
        return sparse.csr_matrix(
            (self.weights, (np.arange(self.n_genes), self.buckets)),
            shape=(self.n_genes, self.sketch_dim),
            dtype=np.float64,
        )

def make_countsketch_op(
    n_genes: int,
    sketch_dim: int,
    leverage_scores: Optional[np.ndarray] = None,
    random_state: RandomStateLike = None,
) -> CountSketchOp:
    """Draw a leverage-weighted CountSketch operator.

    Construction (draw order matches the reference for seed parity):

    1. bucket[g] ~ Uniform{0..d-1}; sign[g] ~ Uniform{-1,+1}
    2. amplitude[g] = clip(sqrt(leverage[g] * G + 1e-10), 0.1, 10)
    3. columns are L2-normalized, then globally scaled by sqrt(G / d) so the
       sketch approximately preserves Frobenius norms.
    """
    rng = check_random_state(random_state)

    if leverage_scores is None:
        leverage = np.ones(n_genes) / n_genes
    else:
        leverage = leverage_scores / (np.sum(leverage_scores) + 1e-10)

    buckets = rng.randint(0, sketch_dim, size=n_genes)
    signs = rng.choice([-1, 1], size=n_genes)
    amps = np.clip(np.sqrt(leverage * n_genes + 1e-10), 0.1, 10.0)

    entries = signs * amps
    col_sumsq = np.bincount(buckets, weights=entries**2, minlength=sketch_dim)
    col_norms = np.maximum(np.sqrt(col_sumsq), 1e-10)

    weights = entries * (np.sqrt(n_genes / sketch_dim) / col_norms[buckets])
    return CountSketchOp(
        buckets=buckets.astype(np.int32), weights=weights, sketch_dim=sketch_dim
    )


def project_to_sketch(
    Y_tilde: ArrayLike,
    X_tilde: np.ndarray,
    Omega: sparse.spmatrix,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host projection: Y_sketch = Y @ Omega (N x d), X_sketch = X @ Omega.

    Sparse Y stays sparse through the matmul; outputs are always dense since
    d is small.
    """
    if sparse.issparse(Omega):
        Omega = Omega.tocsr()

    Y_sketch = Y_tilde @ Omega
    if sparse.issparse(Y_sketch):
        Y_sketch = Y_sketch.toarray()

    X_sketch = X_tilde @ Omega
    if sparse.issparse(X_sketch):
        X_sketch = X_sketch.toarray()

    return Y_sketch, X_sketch


def sketch_data(
    Y_tilde: ArrayLike,
    X_tilde: np.ndarray,
    sketch_dim: int = 512,
    leverage_scores: Optional[np.ndarray] = None,
    random_state: RandomStateLike = None,
    backend: str = "auto",
) -> Tuple[np.ndarray, np.ndarray, sparse.spmatrix]:
    """Full sketching pipeline: build operator, project Y and X.

    Parameters
    ----------
    backend : {"auto", "host", "device"}
        "host" and "auto" project on the host; "device" (the dense
        projection on the card) is not ported yet and raises
        ``NotImplementedError``.

    Returns
    -------
    (Y_sketch (N, d), X_sketch (K, d), Omega as scipy CSR)
    """
    n_genes = Y_tilde.shape[1]
    if backend not in ("auto", "host", "device"):
        raise ValueError(
            f"Unknown backend: {backend!r} (use 'auto' | 'host' | 'device')"
        )
    if backend == "device":
        raise NotImplementedError(
            "backend='device' (the CountSketch kernel) is not ported to "
            "flashdeconv_tpu_torch yet (ROADMAP.md, Queue 1 #7); use "
            "backend='host'"
        )
    op = make_countsketch_op(n_genes, sketch_dim, leverage_scores, random_state)
    Omega = op.to_csr()

    if sparse.issparse(Y_tilde):
        # Native host scatter (flashdeconv_tpu_torch/native/host_kernels.cpp):
        # out[r, bucket[g]] += w[g] * Y[r, g] threaded over row blocks —
        # bit-identical to the scipy CSR matmul (same per-row nnz
        # accumulation order) at ~30x the throughput. Falls through to
        # scipy when the native library is unavailable.
        from flashdeconv_tpu_torch import native

        Y_csr = Y_tilde.tocsr()
        Y_sketch = native.countsketch_project(
            Y_csr, op.buckets, op.weights, op.sketch_dim
        )
        if Y_sketch is not None:
            X_sketch = np.asarray(X_tilde @ Omega)
            return Y_sketch, X_sketch, Omega

    Y_sketch, X_sketch = project_to_sketch(Y_tilde, X_tilde, Omega)
    return Y_sketch, X_sketch, Omega
