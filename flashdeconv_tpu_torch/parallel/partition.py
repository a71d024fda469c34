"""Graph partitioning for the spot-sharded BCD solve: the shard plan.

The port's own copy of :mod:`flashdeconv_tpu.parallel.partition` (host
numpy, held bitwise against it by ``tests/test_torch_host.py``). Spots are
partitioned into ``n_shards`` equal contiguous blocks of a
locality-preserving ordering (:mod:`flashdeconv_tpu_torch.parallel.ordering`).
The only cross-spot dependency of a BCD sweep is the 1-hop neighbour sum,
so each shard needs, per sweep, the current beta rows of the *boundary*
spots owned by other shards:

1. every shard publishes its **send set** — the union of its rows
   referenced by any other shard — padded to the global max
   ``halo_width``;
2. the shards' send sets are pooled into one boundary buffer of
   ``n_shards * halo_width`` rows;
3. each shard's neighbour table is pre-remapped so remote-neighbour entries
   index directly into ``[local | pooled]`` (padding slots hold its
   width, which the neighbour sums read as zero), and the sweep kernel
   itself is unchanged.

All index remapping happens once on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import sparse

from flashdeconv_tpu_torch.parallel.ordering import spot_order


@dataclass(frozen=True)
class ShardPlan:
    """Host-precomputed layout for a spot-sharded solve.

    All row-indexed arrays live in the *ordered, padded* spot space of size
    ``n_shards * shard_size``; ``perm`` maps ordered position -> original spot
    index for the first ``n_spots`` positions.
    """

    n_spots: int
    n_shards: int
    shard_size: int          # spots per shard incl. padding
    halo_width: int          # boundary rows published per shard (padded max)
    perm: np.ndarray         # (n_spots,) ordered position -> original index
    nbr_idx: np.ndarray      # (n_shards*shard_size, max_deg) int32, remapped
    n_nbrs: np.ndarray       # (n_shards*shard_size,) int32 true degrees
    send_idx: np.ndarray     # (n_shards*halo_width,) int32 shard-local rows,
                             # padding slots == shard_size (zero sentinel)
    spot_mask: np.ndarray    # (n_shards*shard_size,) bool, False == padding

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.shard_size

    def scatter(self, arr: np.ndarray, fill=0.0) -> np.ndarray:
        """Reorder a (n_spots, ...) array into ordered+padded layout."""
        out_shape = (self.n_padded,) + arr.shape[1:]
        out = np.full(out_shape, fill, dtype=arr.dtype)
        out[: self.n_spots] = arr[self.perm]
        return out

    def gather(self, arr: np.ndarray) -> np.ndarray:
        """Inverse of :meth:`scatter`: back to original spot order."""
        out = np.empty((self.n_spots,) + arr.shape[1:], dtype=arr.dtype)
        out[self.perm] = arr[: self.n_spots]
        return out


def plan_shards(
    A: sparse.spmatrix,
    n_shards: int,
    coords: Optional[np.ndarray] = None,
    order: str = "morton",
    pad_deg_to: int = 1,
    pad_shard_to: int = 1,
) -> ShardPlan:
    """Build the :class:`ShardPlan` for adjacency ``A`` over ``n_shards``.

    Parameters
    ----------
    A : (N, N) sparse adjacency (binary, symmetric).
    coords : spot coordinates for the locality ordering; if None (or
        ``order='none'``) spots keep their input order.
    pad_deg_to : round max degree up to a multiple (layout alignment).
    pad_shard_to : round shard_size up to a multiple (e.g. the Pallas
        coordinate-pass block size); padded rows are masked out.
    """
    A_csr = A.tocsr()
    n = A_csr.shape[0]
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")

    if coords is not None:
        perm = spot_order(coords, method=order)
    else:
        perm = np.arange(n)

    shard_size = -(-max(n, 1) // n_shards)
    if pad_shard_to > 1:
        shard_size = -(-shard_size // pad_shard_to) * pad_shard_to
    n_pad = n_shards * shard_size

    # Permute the graph into ordered space: P A P^T.
    A_ord = A_csr[perm][:, perm].tocsr() if n > 0 else A_csr

    counts = np.zeros(n_pad, dtype=np.int32)
    counts[:n] = np.diff(A_ord.indptr).astype(np.int32)
    max_deg = int(counts.max()) if n > 0 else 0
    if pad_deg_to > 1 and max_deg > 0:
        max_deg = -(-max_deg // pad_deg_to) * pad_deg_to
    max_deg = max(max_deg, 1)

    # Dense padded neighbor table in ordered-global space; padding = -1.
    nbr_g = np.full((n_pad, max_deg), -1, dtype=np.int64)
    if A_ord.nnz > 0:
        from flashdeconv_tpu_torch.utils.graph import _csr_row_positions

        row_of, pos = _csr_row_positions(A_ord, counts[:n])
        nbr_g[row_of, pos] = A_ord.indices

    owner = np.where(nbr_g >= 0, nbr_g // shard_size, -1)
    row_shard = (np.arange(n_pad) // shard_size)[:, None]
    is_remote = (owner >= 0) & (owner != row_shard)

    # Per-owner send sets: rows of shard t referenced remotely by anyone.
    send_rows = []  # list of (sorted local-row arrays), one per shard
    halo_width = 0
    for t in range(n_shards):
        referenced = np.unique(nbr_g[is_remote & (owner == t)])
        send_rows.append((referenced - t * shard_size).astype(np.int64))
        halo_width = max(halo_width, referenced.size)
    halo_width = max(halo_width, 1)

    send_idx = np.full(n_shards * halo_width, shard_size, dtype=np.int32)
    for t, rows in enumerate(send_rows):
        send_idx[t * halo_width : t * halo_width + rows.size] = rows

    # Remap the neighbor table into per-shard extended-buffer coordinates:
    #   local neighbor j (same shard)      -> j mod shard_size
    #   remote neighbor, owner t, slot p   -> shard_size + t*halo_width + p
    #   padding                            -> shard_size + n_shards*halo_width
    sentinel = shard_size + n_shards * halo_width
    nbr_local = np.full((n_pad, max_deg), sentinel, dtype=np.int64)

    local_mask = (owner >= 0) & ~is_remote
    nbr_local[local_mask] = nbr_g[local_mask] % shard_size

    if is_remote.any():
        # slot p = searchsorted into the owner's sorted send set
        r_owner = owner[is_remote]
        r_local = nbr_g[is_remote] % shard_size
        slots = np.empty(r_owner.size, dtype=np.int64)
        for t in range(n_shards):
            sel = r_owner == t
            if sel.any():
                slots[sel] = np.searchsorted(send_rows[t], r_local[sel])
        nbr_local[is_remote] = shard_size + r_owner * halo_width + slots

    spot_mask = np.zeros(n_pad, dtype=bool)
    spot_mask[:n] = True

    return ShardPlan(
        n_spots=n,
        n_shards=n_shards,
        shard_size=shard_size,
        halo_width=halo_width,
        perm=perm,
        nbr_idx=nbr_local.astype(np.int32),
        n_nbrs=counts,
        send_idx=send_idx,
        spot_mask=spot_mask,
    )


def halo_fraction(plan: ShardPlan) -> float:
    """Fraction of rows exchanged per sweep (diagnostic: lower is better)."""
    sent = int((plan.send_idx < plan.shard_size).sum())
    return sent / max(plan.n_spots, 1)
