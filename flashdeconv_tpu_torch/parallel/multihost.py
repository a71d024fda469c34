"""Multi-process execution on ``torch.distributed``.

Counterpart of :mod:`flashdeconv_tpu.parallel.multihost`, with
``torch.distributed`` in place of ``jax.distributed`` and
``multihost_utils``: the thin layer that takes the spot-sharded solve from
one process to a job of several, one process a card (or several on one
card, or on the CPU):

* :func:`initialize` — ``torch.distributed.init_process_group`` (idempotent);
  with no arguments it reads what ``torchrun`` sets.
* :func:`global_spot_mesh` — a :class:`~flashdeconv_tpu_torch.parallel.Mesh`
  over every process's shards, host-major (process 0's shards first), so
  contiguous Morton blocks land on one process and only shard boundaries
  cross processes.
* :func:`host_spot_range` — which contiguous spot rows this process owns
  under a :class:`~flashdeconv_tpu_torch.parallel.ShardPlan`.
* :func:`allreduce_sums`, :func:`allgather_rows`, :func:`process_row_offsets`
  and the distributed graph, gene-mean and gene-selection passes that
  :meth:`~flashdeconv_tpu_torch.FlashDeconv.fit_distributed` runs.

Usage, the same script on every process (``torchrun --nproc-per-node 2
script.py``)::

    from flashdeconv_tpu_torch.parallel import multihost, sharded_bcd_solve
    multihost.initialize()
    mesh = multihost.global_spot_mesh()
    beta, info = sharded_bcd_solve(Y_sketch, X_sketch, A, coords=coords,
                                   mesh=mesh)

Each process builds device operands only for its own shards; every process
returns the same host f64 beta. The host helpers exchange by
``all_gather`` and reduce in process order on every process, never by an
``all_reduce``, so every process gets the same bits; they travel over Gloo
(a Gloo group beside the default one when that is NCCL).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flashdeconv_tpu_torch.parallel._runner import (
    Mesh,
    all_gather_host,
    process_count,
    process_index,
)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Start the ``torch.distributed`` default group (idempotent).

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` and
    ``process_id`` name the job; each one not given is read from what
    ``torchrun`` sets (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). With none of them given and no ``torchrun`` environment the
    process runs alone: nothing is started. ``backend`` defaults to
    "nccl" when CUDA is present and "gloo" otherwise; under NCCL each
    process's current card becomes ``LOCAL_RANK`` (else its rank) modulo
    the visible cards. NCCL takes one card a process: several processes on
    one card must pass ``backend="gloo"``. A backend that fails to start
    raises; nothing falls back to another.
    """
    if dist.is_initialized():
        return
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and "WORLD_SIZE" not in env):
        return
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        if world == 1 and "MASTER_ADDR" not in env:
            return
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_local_rank(rank) % torch.cuda.device_count())
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world, rank=rank)


def _local_rank(rank: Optional[int] = None) -> int:
    """``LOCAL_RANK`` when ``torchrun`` sets it, else the rank."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else (
        process_index() if rank is None else rank)


def global_spot_mesh(shards_per_process: int = 1, device="cuda") -> Mesh:
    """A mesh of ``shards_per_process`` shards on each process of the job,
    host-major (process 0's shards first, as ``jax.devices()`` orders a
    job's devices); this process's shards on ``device``: with "cuda",
    ``cuda:(LOCAL_RANK % device_count)`` (its rank on one host without
    ``torchrun``), with "cpu" the CPU. Without a process group it is a
    mesh of ``shards_per_process`` shards on this process."""
    if shards_per_process < 1:
        raise ValueError(
            f"shards_per_process must be >= 1, got {shards_per_process}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", _local_rank() % torch.cuda.device_count())
    n = process_count()
    owners = None if n == 1 else np.repeat(np.arange(n), shards_per_process)
    return Mesh([dev] * (n * shards_per_process), owners=owners)


def _stacked(arr: np.ndarray) -> np.ndarray:
    """Every process's ``arr`` (one shape and dtype on all of them),
    stacked in process order: (n_processes, *arr.shape)."""
    parts = all_gather_host(torch.from_numpy(np.ascontiguousarray(arr)))
    return np.stack([p.numpy() for p in parts])


def allreduce_sums(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Element-wise sum of small host arrays across all processes.

    Single-process: identity. Multi-process: one all-gather of the f64
    concatenation, summed in process order (the arrays are O(n_genes), so
    one round trip covers the whole reduction).
    """
    if process_count() == 1:
        return arrays
    flat = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])
    summed = _stacked(flat).sum(axis=0)
    out = []
    offset = 0
    for a in arrays:
        n = np.asarray(a).size
        out.append(summed[offset:offset + n].reshape(np.shape(a)))
        offset += n
    return tuple(out)


def allgather_rows(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-process row blocks into the global array (row axis 0).

    Every process passes its own (possibly empty) block of rows in global
    order — process 0's rows first, then process 1's, etc. — and every
    process returns the identical concatenated array. Row counts may differ
    across processes (padded to the largest count and sliced). Trailing
    dimensions and dtype must match across processes.

    Single-process: returns ``arr`` unchanged (no copy).
    """
    if process_count() == 1:
        return np.asarray(arr)
    arr = np.ascontiguousarray(arr)
    counts = _stacked(np.asarray([arr.shape[0]], dtype=np.int64)).ravel()
    max_rows = int(counts.max())
    if max_rows == 0:
        return arr
    padded = np.zeros((max_rows,) + arr.shape[1:], dtype=arr.dtype)
    padded[:arr.shape[0]] = arr
    gathered = _stacked(padded)
    return np.concatenate(
        [gathered[p, :counts[p]] for p in range(gathered.shape[0])], axis=0
    )


def process_row_offsets(n_local: int) -> Tuple[int, int, int]:
    """(row_start, row_stop, n_global) of this process's contiguous slice.

    The one-call distributed fit's data contract: process p holds global
    rows ``[start_p, stop_p)`` where the starts are the exclusive prefix
    sums of the per-process row counts, in process order.
    """
    if process_count() == 1:
        return 0, n_local, n_local
    counts = _stacked(np.asarray([n_local], dtype=np.int64)).ravel()
    p = process_index()
    start = int(counts[:p].sum())
    return start, start + n_local, int(counts.sum())


def distributed_knn_graph(
    coords_local: np.ndarray,
    k: int = 6,
    include_self: bool = False,
    coords_global: Optional[np.ndarray] = None,
):
    """Global symmetrized kNN adjacency from per-process coordinate slices.

    Exact multi-process counterpart of
    :func:`flashdeconv_tpu_torch.utils.graph.build_knn_graph` on the
    concatenated coordinates: the (16 B/spot) coordinates are all-gathered
    once and every process builds the same KD-tree, but each process runs
    the **queries** — the O(N log N) bulk of the build — only for its own
    rows, then the directed edge lists are exchanged (one all-gather) and
    symmetrized identically everywhere. Per-query results do not depend on
    which process issues them, so the result is bit-identical to the
    single-process build on the gathered coordinates.

    Returns ``(A, coords_global)`` with ``A`` the global scipy CSR
    adjacency, identical on every process.
    """
    from scipy import sparse
    from scipy.spatial import cKDTree

    if coords_global is None:
        coords_global = allgather_rows(np.asarray(coords_local, np.float64))
    n = coords_global.shape[0]
    row_start, _, _ = process_row_offsets(np.asarray(coords_local).shape[0])

    k_eff = min(k, n - 1)
    if k_eff <= 0:
        if include_self and n > 0:
            return (
                sparse.eye(n, dtype=np.float64, format="csr"), coords_global
            )
        return sparse.csr_matrix((n, n), dtype=np.float64), coords_global

    tree = cKDTree(coords_global)
    coords_local = np.asarray(coords_local, dtype=coords_global.dtype)
    if coords_local.shape[0] > 0:
        _, nbrs = tree.query(coords_local, k=k_eff + 1, workers=-1)
        rows = np.repeat(
            np.arange(row_start, row_start + coords_local.shape[0]),
            k_eff + 1,
        )
        cols = np.asarray(nbrs).ravel()
        if not include_self:
            keep = rows != cols
            rows, cols = rows[keep], cols[keep]
        edges_local = np.column_stack([rows, cols]).astype(np.int64)
    else:
        edges_local = np.zeros((0, 2), dtype=np.int64)

    edges = allgather_rows(edges_local)
    A = sparse.csr_matrix(
        (np.ones(edges.shape[0], dtype=np.float64),
         (edges[:, 0], edges[:, 1])),
        shape=(n, n),
    )
    A = A + A.T
    A.data[:] = 1.0
    return A, coords_global


def distributed_adjacency(
    coords_local: np.ndarray,
    method: str = "knn",
    k: int = 6,
    radius: Optional[float] = None,
    coords_global: Optional[np.ndarray] = None,
):
    """Global spatial adjacency from per-process coordinate slices.

    ``"knn"`` distributes the query workload (:func:`distributed_knn_graph`);
    ``"radius"`` / ``"grid"`` build from the gathered coordinates identically
    on every process (``cKDTree.query_pairs`` is all-pairs; the coordinates
    are 16 B/spot, so the gathered build is cheap and matches the
    single-process graph exactly). Returns ``(A, coords_global)``.
    """
    from flashdeconv_tpu_torch.utils.graph import (
        build_grid_graph,
        build_radius_graph,
    )

    if method == "knn":
        return distributed_knn_graph(
            coords_local, k=k, coords_global=coords_global
        )
    if coords_global is None:
        coords_global = allgather_rows(np.asarray(coords_local, np.float64))
    if method == "radius":
        if radius is None:
            raise ValueError("radius must be specified for radius method")
        return build_radius_graph(coords_global, radius=radius), coords_global
    if method == "grid":
        return build_grid_graph(coords_global), coords_global
    raise ValueError(f"Unknown method: {method}")


def distributed_subset_col_mean(
    Y_local, gene_idx: np.ndarray
) -> np.ndarray:
    """Global column means of ``Y[:, gene_idx]`` over spot-sharded rows.

    One :func:`allreduce_sums` over the per-process column sums and row
    counts (the pearson preprocess needs the global gene means; the f64
    sum's order differs from the single-process pass's, so the two agree
    to the last bits, not bitwise).
    """
    from scipy import sparse

    from flashdeconv_tpu_torch import native

    n_local = int(Y_local.shape[0])
    mu_local = (
        native.subset_col_mean(Y_local, gene_idx) if n_local > 0 else None
    )
    if mu_local is not None:
        col_sum = mu_local * float(n_local)
    else:
        sub = Y_local[:, gene_idx]
        if sparse.issparse(sub):
            col_sum = np.asarray(sub.sum(axis=0), dtype=np.float64).ravel()
        else:
            col_sum = np.asarray(sub, dtype=np.float64).sum(axis=0)
    col_sum, n_total = allreduce_sums(
        col_sum, np.asarray([float(n_local)])
    )
    return col_sum / max(float(n_total[0]), 1.0)


def distributed_gene_moments(Y_local) -> Tuple[np.ndarray, np.ndarray]:
    """HVG moments over a spot-sharded count matrix.

    Each process computes the additive log1p-CPM column sums of its own
    spot slice (O(local nnz), through the native kernel when available)
    and the sums are all-reduced — the full matrix never exists in one
    process. The per-spot CPM scaling needs only each row's own library
    size, so the local pass is exact. Returns the (means, variances) the
    single-process path gives for the concatenated matrix.
    """
    from scipy import sparse

    from flashdeconv_tpu_torch.utils.genes import (
        log1p_cpm_sums,
        moments_from_sums,
    )

    if sparse.issparse(Y_local):
        col_sum, col_sumsq = log1p_cpm_sums(Y_local)
    else:
        # Dense slice: the single-process dense moments' log1p-CPM
        # transform; the all-reduced sum-of-squares variance agrees with
        # its two-pass np.var to f64 rounding (not bitwise).
        Yd = np.asarray(Y_local, dtype=np.float64)
        lib = np.maximum(Yd.sum(axis=1, keepdims=True), 1.0)
        Ylog = np.log1p(Yd / lib * 1e4)
        col_sum = Ylog.sum(axis=0)
        col_sumsq = np.einsum("ij,ij->j", Ylog, Ylog)
    n_local = np.asarray([float(Y_local.shape[0])])
    col_sum, col_sumsq, n_total = allreduce_sums(col_sum, col_sumsq, n_local)
    return moments_from_sums(col_sum, col_sumsq, int(n_total[0]))


def distributed_select_informative_genes(
    Y_local,
    X: np.ndarray,
    n_hvg: int = 2000,
    n_markers_per_type: int = 50,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-process
    :func:`~flashdeconv_tpu_torch.utils.genes.select_informative_genes`.

    ``Y_local`` is this process's spot slice (see :func:`host_spot_range`);
    the reference ``X`` is replicated, so marker selection and leverage
    scores are computed identically on every process, and the HVG moments
    are the one cross-process reduction. Every process returns the same
    gene set.
    """
    from flashdeconv_tpu_torch.utils.genes import (
        compute_leverage_scores,
        hvg_from_moments,
        select_markers,
    )

    means, variances = distributed_gene_moments(Y_local)
    hvg_idx = hvg_from_moments(means, variances, n_top=n_hvg)
    marker_idx, _ = select_markers(X, n_markers=n_markers_per_type)
    gene_idx = np.union1d(hvg_idx, marker_idx).astype(np.intp)
    if gene_idx.size == 0:
        raise ValueError(
            "No genes selected. Increase n_hvg or n_markers_per_type."
        )
    return gene_idx, compute_leverage_scores(X[:, gene_idx])


def host_spot_range(plan, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[start, stop) of ordered-spot rows owned by this process.

    Parameters
    ----------
    plan : :class:`~flashdeconv_tpu_torch.parallel.partition.ShardPlan`
        The plan the solve will run with (``plan.n_shards`` must equal the
        mesh's shard count). Using the plan — not a recomputed
        ``ceil(n/S)`` — matters because the solver may pad ``shard_size``.
    mesh : :class:`~flashdeconv_tpu_torch.parallel.Mesh`, default
        :func:`global_spot_mesh`.

    Ordered-spot space is the plan's permuted, padded layout; use
    ``plan.perm`` to map back to the caller's original spot indices.
    """
    if mesh is None:
        mesh = global_spot_mesh()
    if plan.n_shards != len(mesh):
        raise ValueError(
            f"plan has {plan.n_shards} shards but mesh has "
            f"{len(mesh)} devices"
        )
    local = list(mesh.local)
    if local != list(range(local[0], local[-1] + 1)):
        # An interleaved mesh (shards dealt round-robin to processes) would
        # make [first, last+1) span other processes' shards — every
        # process would then feed the wrong Y rows with no error anywhere
        # downstream. global_spot_mesh() builds it host-major.
        raise ValueError(
            "this process's mesh shards are not contiguous in the mesh "
            f"(local shard indices {local}); host_spot_range requires a "
            "host-major mesh — build it with global_spot_mesh()"
        )
    shard_size = plan.shard_size
    return local[0] * shard_size, (local[-1] + 1) * shard_size
