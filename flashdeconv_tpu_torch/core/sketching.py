"""Leverage-weighted CountSketch compression of the gene axis (G -> d).

The port's own copy of :mod:`flashdeconv_tpu.core.sketching`.

The sketch operator is constructed **host-side with numpy's MT19937** so a
given integer seed draws the identical bucket/sign/amplitude sequence as the
reference implementation (reference ``flashdeconv/core/sketching.py:48-84``) —
sketch-operator parity is a prerequisite for output parity on the reference
test scenarios.

The *projection* Y @ Omega has two execution paths:

* host: the native CSR scatter or a scipy sparse matmul, O(nnz) — the
  default for sparse spatial counts, which never need to be densified (only
  the dense N x d sketch ever reaches the device);
* device: the full-f32 matmul or the hand-written CUDA CountSketch kernel
  (see :mod:`flashdeconv_tpu_torch.ops.countsketch`), for dense Y on a CUDA
  device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch
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

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        """Materialize as a dense (n_genes x sketch_dim) matrix."""
        dense = np.zeros((self.n_genes, self.sketch_dim), dtype=dtype)
        dense[np.arange(self.n_genes), self.buckets] = self.weights.astype(dtype)
        return dense


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


def build_countsketch_matrix(
    n_genes: int,
    sketch_dim: int,
    leverage_scores: Optional[np.ndarray] = None,
    random_state: RandomStateLike = None,
) -> sparse.csr_matrix:
    """CountSketch operator as a scipy CSR matrix (n_genes x sketch_dim)."""
    return make_countsketch_op(
        n_genes, sketch_dim, leverage_scores, random_state
    ).to_csr()


def build_sparse_rademacher_matrix(
    n_genes: int,
    sketch_dim: int,
    sparsity: float = 0.1,
    leverage_scores: Optional[np.ndarray] = None,
    random_state: RandomStateLike = None,
) -> sparse.csr_matrix:
    """Sparse Rademacher sketch: each entry 0 or +-1/sqrt(sparsity*G/d).

    Per-gene inclusion probability grows with leverage; every column is
    guaranteed at least one non-zero. Column-sequential RNG draws match the
    reference (ref ``core/sketching.py:135-149``) for seed parity.
    """
    rng = check_random_state(random_state)

    if leverage_scores is None:
        leverage = np.ones(n_genes) / n_genes
    else:
        leverage = leverage_scores / (np.sum(leverage_scores) + 1e-10)

    gene_probs = np.clip(sparsity * (1 + leverage * n_genes), 0.01, 1.0)
    scale = 1.0 / np.sqrt(sparsity * n_genes / sketch_dim)

    rows, cols, data = [], [], []
    for j in range(sketch_dim):
        selected = np.flatnonzero(rng.random(n_genes) < gene_probs)
        if selected.size == 0:
            selected = np.array([rng.randint(n_genes)])
        signs = rng.choice([-1, 1], size=selected.size)
        rows.extend(selected)
        cols.extend([j] * selected.size)
        data.extend(signs * scale)

    return sparse.csr_matrix(
        (data, (rows, cols)), shape=(n_genes, sketch_dim), dtype=np.float64
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
    method: str = "countsketch",
    random_state: RandomStateLike = None,
    backend: str = "auto",
    *,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, sparse.spmatrix]:
    """Full sketching pipeline: build operator, project Y and X.

    Parameters
    ----------
    backend : {"auto", "host", "device"}
        "host" projects on the host; "device" projects dense Y on
        ``device`` via :mod:`flashdeconv_tpu_torch.ops.countsketch`; "auto"
        picks host for sparse Y (O(nnz), no densification) and device for
        dense Y when ``device`` is a CUDA device.
    device : the torch device of the device projection ("cuda" by default;
        raises without a card when the device route is taken).

    Returns
    -------
    (Y_sketch (N, d), X_sketch (K, d), Omega as scipy CSR); the device
    route returns the sketches as host float32 arrays.
    """
    n_genes = Y_tilde.shape[1]

    if method == "countsketch":
        op = make_countsketch_op(n_genes, sketch_dim, leverage_scores, random_state)
        Omega = op.to_csr()
    elif method == "rademacher":
        op = None
        Omega = build_sparse_rademacher_matrix(
            n_genes, sketch_dim, leverage_scores=leverage_scores,
            random_state=random_state,
        )
    else:
        raise ValueError(f"Unknown sketching method: {method}")

    if backend not in ("auto", "host", "device"):
        raise ValueError(
            f"Unknown backend: {backend!r} (use 'auto' | 'host' | 'device')"
        )
    if backend == "device":
        if sparse.issparse(Y_tilde):
            raise ValueError(
                "backend='device' requires dense Y (the device projection "
                "would densify the whole matrix); sparse inputs use the "
                "O(nnz) host path — pass backend='host' or 'auto'."
            )
        if op is None:
            raise ValueError(
                "backend='device' is only available for method='countsketch'."
            )
    use_device = backend == "device" or (
        backend == "auto"
        and op is not None
        and not sparse.issparse(Y_tilde)
        and _device_projection_available(device)
    )

    if use_device and op is not None:
        from flashdeconv_tpu_torch.core.solver import resolve_device
        from flashdeconv_tpu_torch.ops.countsketch import countsketch_project

        dev = resolve_device(device)
        Y_sketch = countsketch_project(np.asarray(Y_tilde), op, device=dev)
        X_sketch = countsketch_project(np.asarray(X_tilde), op, device=dev)
        return Y_sketch.cpu().numpy(), X_sketch.cpu().numpy(), Omega

    if op is not None and sparse.issparse(Y_tilde):
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


def _device_projection_available(device) -> bool:
    """Whether ``backend="auto"`` projects dense Y on ``device``: on a CUDA
    device, as the JAX package does on any accelerator backend."""
    return torch.device(device).type == "cuda"
