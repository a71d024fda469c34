"""Spatial orderings for locality-preserving spot partitioning.

The port's own copy of :mod:`flashdeconv_tpu.parallel.ordering` (host
numpy, held bitwise against it by ``tests/test_torch_host.py``).
Contiguous block partitioning of a spatially ordered spot list makes
cross-shard graph edges rare (boundary rows scale as O(sqrt(N/S)*k) per
shard for planar graphs), which keeps the per-sweep halo exchange of the
sharded solver (:mod:`flashdeconv_tpu_torch.parallel.solver`) small
relative to compute.
"""

from __future__ import annotations

import numpy as np

# Bits per coordinate axis in the Morton code. 2 axes * 21 bits and
# 3 axes * 21 bits both fit an int64 code.
_MORTON_BITS = 21


def _spread_bits(v: np.ndarray, n_axes: int) -> np.ndarray:
    """Interleave zeros between the bits of v: bit i moves to bit i*n_axes."""
    out = np.zeros_like(v)
    for bit in range(_MORTON_BITS):
        out |= ((v >> bit) & 1) << (bit * n_axes)
    return out


def morton_codes(coords: np.ndarray) -> np.ndarray:
    """Z-order (Morton) code per point, int64, over up to 3 coordinate axes.

    Coordinates are min-max quantized to 21 bits per axis; axes beyond the
    third are ignored (spatial platforms are 2-D or 3-D).
    """
    coords = np.asarray(coords, dtype=np.float64)
    if coords.ndim != 2:
        raise ValueError(f"coords must be 2-D, got shape {coords.shape}")
    n_axes = min(coords.shape[1], 3)
    lo = coords[:, :n_axes].min(axis=0)
    span = coords[:, :n_axes].max(axis=0) - lo
    span[span == 0] = 1.0
    scale = (2**_MORTON_BITS - 1) / span
    q = ((coords[:, :n_axes] - lo) * scale).astype(np.int64)
    code = np.zeros(coords.shape[0], dtype=np.int64)
    for axis in range(n_axes):
        code |= _spread_bits(q[:, axis], n_axes) << axis
    return code


def morton_order(coords: np.ndarray) -> np.ndarray:
    """Permutation that sorts spots along the Z-order space-filling curve.

    ``perm[i]`` is the original index of the spot placed at ordered position
    ``i``. Stable sort keeps input order for co-located spots so the
    permutation is deterministic.
    """
    return np.argsort(morton_codes(coords), kind="stable")


def spot_order(coords: np.ndarray, method: str = "morton") -> np.ndarray:
    """Dispatch spot-ordering strategies ("morton" | "none")."""
    n = np.asarray(coords).shape[0]
    if method == "none":
        return np.arange(n)
    if method == "morton":
        return morton_order(coords)
    raise ValueError(f"Unknown spot ordering: {method!r} (use 'morton' | 'none')")
