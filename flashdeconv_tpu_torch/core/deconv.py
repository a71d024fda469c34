"""FlashDeconv orchestrator of the port — the array-level API on a torch device.

Counterpart of :class:`flashdeconv_tpu.core.deconv.FlashDeconv`. Stages
1-5 — gene selection, normalisation, CountSketch (through the native fused
Xty pass for CSR counts, streamed to the card in row chunks above
``native.XTY_STREAM_CHUNK_ROWS`` spots; on ``device`` for dense counts,
through the CUDA CountSketch kernel when G >= 4096 and N >= 1024), the
spatial graph and the lambda auto-tune — are the port's own copies of the
JAX package's host functions; stage 6 is the solve of
:mod:`flashdeconv_tpu_torch.core.solver` on ``device``, on whichever of its
three tiers the graph takes (fused banded, unfused banded, gather), or,
with ``mesh`` or ``n_shards > 1``, the spot-sharded solve of
:mod:`flashdeconv_tpu_torch.parallel` (banded mesh or halo plan).

The fit's outputs follow the JAX class: on a single-device ``cuda`` fit
(or wherever ``device_outputs=True``) beta stays on the device, the
proportions are normalised there and fetched in ``fetch_dtype``, the
dominant type is a device argmax, and ``beta_`` / ``proportions_`` fetch
lazily. Besides :meth:`FlashDeconv.fit` the class has ``warm_start``,
:meth:`~FlashDeconv.fit_lambda_path`, the getters, ``summary`` and
``save`` / ``load`` (the JAX package's ``.npz`` keys). ``solver_dtype``
float64, or more than 256 cell types, solves on the JAX package's XLA
tier. :meth:`~FlashDeconv.fit_distributed` is the multi-process fit: each
process of a ``torch.distributed`` job passes only its slice of the spots,
and stage 6 runs on a mesh whose shards span the processes
(:mod:`flashdeconv_tpu_torch.parallel.multihost`).
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu_torch import native
from flashdeconv_tpu_torch.core.preprocess import (
    _PREPROCESS_METHODS,
    _log_cpm_dense,
    _pearson_dense,
    _pearson_sigma,
    _zero_poisoned_csr_rows,
    preprocess_data,
)
from flashdeconv_tpu_torch.core.sketching import (
    make_countsketch_op,
    sketch_data,
)
from flashdeconv_tpu_torch.core.solver import (
    GraphDecomposition,
    fetch_to_host,
    normalize_proportions,
    normalize_proportions_device,
    prepare_bcd,
    resolve_device,
    solve_dtype,
)
from flashdeconv_tpu_torch.core.spatial import auto_tune_lambda
from flashdeconv_tpu_torch.utils.genes import select_informative_genes
from flashdeconv_tpu_torch.utils.graph import coords_to_adjacency
from flashdeconv_tpu_torch.utils.timing import StageTimer, span, trace

ArrayLike = Union[np.ndarray, sparse.spmatrix]

_FETCH_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
                 "float32": torch.float32}


def stream_xty(chunks, n_rows: int, n_types: int, device: torch.device,
               dtype: torch.dtype = torch.float32
               ) -> Tuple[torch.Tensor, float]:
    """The (n_rows, n_types) Xty in ``dtype`` (the solve's) on ``device``
    and YtY from the chunks of a native ``*_xty_chunks`` generator.

    Each chunk is cast to ``dtype`` on the host into one of two staging
    buffers (pinned for a CUDA device) and its copy to the device is queued
    at once, so it runs while the generator computes the next chunk. A
    buffer is refilled only after the event recorded behind its last copy
    has completed, so no host bytes are overwritten or freed under a copy
    in flight. The values are those of the cast
    :class:`~flashdeconv_tpu_torch.core.solver.BCDProblem` makes of a host
    Xty.
    """
    xty = torch.empty((n_rows, n_types), dtype=dtype, device=device)
    cuda = xty.is_cuda
    stage, events, yty = [None, None], [None, None], 0.0
    for i, (a, b, part, yty_part) in enumerate(chunks):
        slot = i % 2
        if events[slot] is not None:
            events[slot].synchronize()
        if stage[slot] is None or stage[slot].shape[0] < b - a:
            stage[slot] = torch.empty((b - a, n_types), dtype=dtype,
                                      pin_memory=cuda)
        buf = stage[slot][:b - a]
        buf.copy_(torch.from_numpy(part))
        xty[a:b].copy_(buf, non_blocking=cuda)
        if cuda:
            events[slot] = torch.cuda.Event()
            events[slot].record(torch.cuda.current_stream(device))
        yty += yty_part
    for event in events:
        if event is not None:
            event.synchronize()
    return xty, yty


class FlashDeconv:
    """Spatial-transcriptomics deconvolution with spatial regularisation,
    solved on a torch device.

    Parameters are those of :class:`flashdeconv_tpu.FlashDeconv`, with its
    defaults, plus ``device`` ("cuda" by default; raises without a card,
    "cpu" runs the plain PyTorch sweeps). ``mesh`` (a sequence of torch
    devices, one per shard, a device possibly repeated) or ``n_shards > 1``
    (the first ``n_shards`` cards, or ``n_shards`` shards on the CPU with
    ``device="cpu"``) sends stage 6 to
    :func:`flashdeconv_tpu_torch.parallel.prepare_sharded_bcd`.

    ``device_outputs``: None (auto) keeps beta on the device on a
    single-device ``cuda`` fit, normalises the proportions there in f32
    and fetches only them; False always fetches beta as f64 and normalises
    on the host; True forces the device path on the CPU and on meshes.
    On that path ``fetch_dtype`` ("float16", "bfloat16", "float32") casts
    the proportions on the device before the fetch, and ``outputs``
    chooses what is fetched: "proportions" and/or "dominant" (the device
    argmax, uint8 on the wire at K <= 256, int32 above). ``warm_start``
    starts each fit from the previous fit's ``beta_`` when the shapes
    match. ``solver_dtype`` (float32 or float64) is the solve's dtype, of
    its operands and of the device beta.

    Attributes (after fit): ``beta_``, ``proportions_``, ``dominant_``,
    ``gene_idx_``, ``info_``, ``lambda_used_``, ``adjacency_``,
    ``timings_``, ``n_spots_``, ``n_genes_``, ``n_cell_types_`` and
    ``cell_type_names_``.
    """

    def __init__(
        self,
        sketch_dim: int = 512,
        lambda_spatial: Union[float, str] = "auto",
        rho_sparsity: float = 0.01,
        n_hvg: int = 2000,
        n_markers_per_type: int = 50,
        spatial_method: str = "knn",
        k_neighbors: int = 6,
        radius: Optional[float] = None,
        max_iter: int = 100,
        tol: float = 1e-4,
        preprocess: str = "log_cpm",
        random_state: Optional[int] = 0,
        verbose: bool = False,
        solver_dtype=np.float32,
        mesh=None,
        n_shards: Optional[int] = None,
        warm_start: bool = False,
        device_outputs: Optional[bool] = None,
        fetch_dtype=None,
        outputs: Tuple[str, ...] = ("proportions",),
        device="cuda",
    ):
        if sketch_dim <= 0:
            raise ValueError(f"sketch_dim must be positive, got {sketch_dim}")
        if k_neighbors < 0:
            raise ValueError(
                f"k_neighbors must be non-negative, got {k_neighbors}"
            )
        if max_iter < 0:
            raise ValueError(f"max_iter must be non-negative, got {max_iter}")
        if tol <= 0:
            raise ValueError(f"tol must be positive, got {tol}")
        if isinstance(lambda_spatial, (int, float)) and lambda_spatial < 0:
            raise ValueError(
                f"lambda_spatial must be non-negative, got {lambda_spatial}"
            )
        if rho_sparsity < 0:
            raise ValueError(
                f"rho_sparsity must be non-negative, got {rho_sparsity}"
            )
        if n_hvg < 0:
            raise ValueError(f"n_hvg must be non-negative, got {n_hvg}")
        if n_markers_per_type < 0:
            raise ValueError(
                "n_markers_per_type must be non-negative, got "
                f"{n_markers_per_type}"
            )
        if spatial_method == "radius" and radius is None:
            raise ValueError(
                "radius must be specified when spatial_method='radius'"
            )
        if radius is not None and radius <= 0:
            raise ValueError(f"radius must be positive, got {radius}")
        if preprocess not in _PREPROCESS_METHODS:
            raise ValueError(
                f"Unknown preprocess method: {preprocess}. "
                f"Choose from {_PREPROCESS_METHODS}."
            )
        if n_shards is not None and n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if fetch_dtype is not None:
            fetch_dtype = str(
                fetch_dtype if isinstance(fetch_dtype, str)
                else np.dtype(fetch_dtype).name
            )
            if fetch_dtype not in ("float16", "bfloat16", "float32"):
                raise ValueError(
                    "fetch_dtype must be one of None, 'float16', "
                    f"'bfloat16', 'float32'; got {fetch_dtype!r}"
                )
        outputs = tuple(outputs)
        if not outputs or not set(outputs) <= {"proportions", "dominant"}:
            raise ValueError(
                "outputs must be a non-empty subset of "
                f"('proportions', 'dominant'); got {outputs!r}"
            )
        solve_dtype(solver_dtype)
        self.device = resolve_device(device)
        self.sketch_dim = sketch_dim
        self.lambda_spatial = lambda_spatial
        self.rho_sparsity = rho_sparsity
        self.n_hvg = n_hvg
        self.n_markers_per_type = n_markers_per_type
        self.spatial_method = spatial_method
        self.k_neighbors = k_neighbors
        self.radius = radius
        self.max_iter = max_iter
        self.tol = tol
        self.preprocess = preprocess
        self.random_state = random_state
        self.verbose = verbose
        self.solver_dtype = solver_dtype
        self.mesh = mesh
        self.n_shards = n_shards
        self.warm_start = warm_start
        self.device_outputs = device_outputs
        self.fetch_dtype = fetch_dtype
        self.outputs = outputs

        self.beta_ = None
        self.proportions_ = None
        self.dominant_ = None
        self.gene_idx_ = None
        self.info_ = None
        self.lambda_used_ = None
        self.adjacency_ = None
        self.timings_ = None
        self._fitted = False

    def _validate(self, Y, X, coords, cell_type_names):
        if Y.shape[1] != X.shape[1]:
            raise ValueError(
                f"Gene dimension mismatch: Y has {Y.shape[1]} genes but "
                f"X has {X.shape[1]} genes. They must share the same gene "
                "space (align before calling fit)."
            )
        if coords.shape[0] != Y.shape[0]:
            raise ValueError(
                f"Spot count mismatch: Y has {Y.shape[0]} spots but coords "
                f"has {coords.shape[0]} rows."
            )
        if X.shape[0] == 0:
            raise ValueError(
                "Reference matrix X must contain at least one cell type."
            )
        if cell_type_names is not None and len(cell_type_names) != X.shape[0]:
            raise ValueError(
                f"cell_type_names length ({len(cell_type_names)}) does not "
                f"match number of cell types in X ({X.shape[0]})."
            )

    def _pipeline_operands(self, Y, X, coords, cell_type_names, timer):
        """Stages 1-4 (validation, gene selection, normalisation, sketch,
        graph), shared by :meth:`fit` and :meth:`fit_lambda_path`. Returns
        ``(Y_sketch, X_sketch, A)``; the canonical CSR path leaves
        ``Y_sketch`` None and keeps the fused pass's Xty and YtY, and a
        single-device fit the graph's banded analysis (a future), as
        consume-once state for the solve."""
        if sparse.issparse(Y) and not sparse.isspmatrix_csr(Y):
            Y = Y.tocsr()
        coords = np.asarray(coords)
        self._validate(Y, X, coords, cell_type_names)
        self.n_spots_ = Y.shape[0]
        self.n_genes_ = Y.shape[1]
        self.n_cell_types_ = X.shape[0]
        self.cell_type_names_ = cell_type_names
        self._log(f"FlashDeconv (torch, {self.device}): {Y.shape[0]} spots "
                  f"x {Y.shape[1]} genes, {X.shape[0]} cell types")
        # A previous aborted fit's operands describe that fit, not this.
        self._clear_consume_once()

        # The spatial graph and its banded analysis depend only on coords:
        # build them on background threads while stages 1-3 run; the solve
        # joins the analysis.
        pool = concurrent.futures.ThreadPoolExecutor(2)
        graph_f = pool.submit(
            coords_to_adjacency, coords, method=self.spatial_method,
            k=self.k_neighbors, radius=self.radius,
        )
        if not self._is_sharded:
            self._graph_plan_future = pool.submit(
                lambda: GraphDecomposition(graph_f.result(), Y.shape[0],
                                           coords))
        pool.shutdown(wait=False)
        try:
            X_sketch, Y_sketch = self._sketch(Y, X, timer)
        except BaseException:
            graph_f.cancel()
            plan_f = self.__dict__.pop("_graph_plan_future", None)
            if plan_f is not None:
                plan_f.cancel()
            raise
        with timer.stage("spatial_graph"):
            A = graph_f.result()
        self.adjacency_ = A
        return Y_sketch, X_sketch, A

    def _sketch(self, Y, X, timer):
        """Stages 1-3. Returns ``(X_sketch, Y_sketch)``; the canonical CSR
        path returns ``Y_sketch`` None and keeps the (N, K) Xty and YtY of
        the native fused pass as ``_fused_xty`` / ``_fused_yty``."""
        if self.preprocess == "log_cpm":
            use_fused = native.fused_available(Y)
        else:
            use_fused = native.colscale_available(Y)

        with timer.stage("gene_selection"):
            gene_idx, leverage = select_informative_genes(
                Y, X, n_hvg=self.n_hvg,
                n_markers_per_type=self.n_markers_per_type,
            )
            self.gene_idx_ = gene_idx
            X_subset = X[:, gene_idx]
            Y_subset = None
            if not use_fused and sparse.isspmatrix_csr(Y):
                # Threaded native column subset, bitwise scipy's fancy
                # indexing (a selection-matrix matmul, which dominates this
                # stage at atlas-scale nnz); None for a non-float dtype.
                Y_subset = native.csr_column_subset(Y, gene_idx)
            if not use_fused and Y_subset is None:
                Y_subset = Y[:, gene_idx]
        self._log(f"  Selected {len(gene_idx)} genes (HVG + markers)")

        colscale = None
        with timer.stage("preprocess"):
            if use_fused and self.preprocess == "log_cpm":
                X_tilde = _log_cpm_dense(X_subset)
            elif use_fused and self.preprocess == "pearson":
                mu = native.subset_col_mean(Y, gene_idx) + 1e-6
                colscale = 1.0 / _pearson_sigma(mu)
                X_tilde = _pearson_dense(X_subset)
            elif use_fused:  # raw
                X_tilde = X_subset.astype(np.float64, copy=False)
            else:
                Y_tilde, X_tilde = preprocess_data(
                    Y_subset, X_subset, self.preprocess
                )

        with timer.stage("sketch"), trace("sketch"):
            if not use_fused:
                # Dense counts on a CUDA device project there (the
                # CountSketch kernel when G >= 4096 and N >= 1024); sparse
                # ones on the host.
                Y_sketch, X_sketch, _ = sketch_data(
                    Y_tilde, X_tilde, sketch_dim=self.sketch_dim,
                    leverage_scores=leverage,
                    random_state=self.random_state, backend="auto",
                    device=self.device,
                )
                return X_sketch, Y_sketch
            op = make_countsketch_op(
                len(gene_idx), self.sketch_dim, leverage_scores=leverage,
                random_state=self.random_state,
            )
            X_sketch = np.asarray(X_tilde @ op.to_csr())
            xty, yty = self._fused_xty_feed(Y, gene_idx, op, X_sketch,
                                            colscale)
            if not np.isfinite(yty):
                # Poisoned counts made YtY non-finite: re-run the feed on a
                # copy with those rows zeroed, as the JAX pipeline does.
                Y_rep = _zero_poisoned_csr_rows(
                    Y, gene_idx, logcpm=self.preprocess == "log_cpm"
                )
                if Y_rep is not None:
                    # Release the poisoned Xty (on the streamed path an
                    # (N, K) device buffer) before making the repaired one.
                    xty = None
                    xty, yty = self._fused_xty_feed(Y_rep, gene_idx, op,
                                                    X_sketch, colscale)
            self._fused_xty, self._fused_yty = xty, yty
            return X_sketch, None

    def _streams_xty(self, n_rows: int) -> bool:
        """True when the fused Xty pass streams to the device: a
        single-device ``cuda`` fit (not :meth:`fit_distributed`, which
        gathers Xty on the host and solves on ``_distributed_mesh``) of
        more than ``native.XTY_STREAM_CHUNK_ROWS`` spots."""
        return (not self._is_sharded and self.device.type == "cuda"
                and "_distributed_mesh" not in self.__dict__
                and n_rows > native.XTY_STREAM_CHUNK_ROWS)

    def _fused_xty_feed(self, Y, gene_idx, op, X_sketch, colscale=None):
        """``(Xty, YtY)`` from the native fused sketch pass: the log-CPM
        kernels for "log_cpm", the column-scale kernels for "pearson"
        (``colscale`` = 1/sigma per subset gene) and "raw" (None). When
        :meth:`_streams_xty`, the pass runs in row chunks
        and Xty is an f32 device tensor, each chunk's copy to the device
        running while the next chunk computes (:func:`stream_xty`); else a
        host (N, K) f64 array, which the solver copies once."""
        args = (Y, gene_idx) + (() if self.preprocess == "log_cpm"
                                else (colscale,))
        args += (op.buckets, op.weights, op.sketch_dim, X_sketch)
        if self.preprocess == "log_cpm":
            full, chunked = (native.fused_log1pcpm_xty,
                             native.fused_log1pcpm_xty_chunks)
        else:
            full, chunked = (native.fused_colscale_xty,
                             native.fused_colscale_xty_chunks)
        if self._streams_xty(Y.shape[0]):
            chunks = chunked(*args, chunk_rows=native.XTY_STREAM_CHUNK_ROWS)
            res = None if chunks is None else stream_xty(
                chunks, Y.shape[0], X_sketch.shape[0], self.device,
                solve_dtype(self.solver_dtype))
        else:
            res = full(*args)
        if res is None:
            raise RuntimeError(
                "native fused xty kernel returned None despite its gate "
                "passing"
            )
        return res

    def _resolve_lambda(self, Y_sketch, X_sketch, A, timer) -> float:
        """Stage 5: ``lambda_spatial``, or its auto-tuned value."""
        with timer.stage("lambda_tuning"):
            if self.lambda_spatial == "auto":
                lambda_ = auto_tune_lambda(Y_sketch, X_sketch, A)
            else:
                lambda_ = float(self.lambda_spatial)
        self._log(f"  lambda = {lambda_:.4f}")
        return lambda_

    def _prepare(self, Y_sketch, X_sketch, A, coords):
        """Stage 6's prepared problem, for :meth:`fit` and
        :meth:`fit_lambda_path`, consuming the pipeline's consume-once
        operands: a single-device ``BCDProblem``, or the spot-sharded
        ``ShardedBCDProblem``."""
        coords = np.asarray(coords)
        xty = self.__dict__.pop("_fused_xty", None)
        yty = self.__dict__.pop("_fused_yty", None)
        with span("flashdeconv.fit.prepare"):
            if not self._is_sharded:
                return prepare_bcd(
                    Y_sketch, X_sketch, A, dtype=self.solver_dtype,
                    coords=coords, xty=xty, yty=yty,
                    graph_plan=self.__dict__.pop("_graph_plan_future", None),
                    device=self.device,
                )
            from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd

            self._log("  solving on a spot-sharded mesh")
            return prepare_sharded_bcd(
                Y_sketch, X_sketch, A, coords=coords, mesh=self.mesh,
                n_shards=self.n_shards, dtype=self.solver_dtype,
                verbose=self.verbose, xty=xty, yty=yty, device=self.device,
            )

    def _device_out(self) -> bool:
        """Whether this fit takes the device-outputs path."""
        if self.device_outputs is None:
            return not self._is_sharded and self.device.type == "cuda"
        return bool(self.device_outputs)

    def fit(self, Y: ArrayLike, X: np.ndarray, coords: np.ndarray,
            cell_type_names: Optional[np.ndarray] = None) -> "FlashDeconv":
        """Run the full pipeline; stores results on the instance.
        ``cell_type_names`` (one per row of X) is kept as
        ``cell_type_names_``."""
        timer = StageTimer()
        try:
            Y_sketch, X_sketch, A = self._pipeline_operands(
                Y, X, coords, cell_type_names, timer)
            lambda_ = self._resolve_lambda(Y_sketch, X_sketch, A, timer)
            self.lambda_used_ = lambda_
            beta_init = None
            if (self.warm_start and self.beta_ is not None
                    and self.beta_.shape == (Y.shape[0], X.shape[0])):
                beta_init = self.beta_
                self._log("  warm start from the previous beta_")
            device_out = self._device_out()
            with timer.stage("solve"), trace("bcd_solve"):
                beta, info = self._prepare(Y_sketch, X_sketch, A,
                                           coords).solve(
                    lambda_=lambda_, rho=self.rho_sparsity,
                    max_iter=self.max_iter, tol=self.tol,
                    verbose=self.verbose, beta_init=beta_init,
                    return_device=device_out)
                props = props_dev = dominant = None
                if device_out:
                    # Normalise on the device; fetch the proportions in
                    # fetch_dtype and/or the argmax, per ``outputs``.
                    with span("flashdeconv.fit.outputs"):
                        props_dev = normalize_proportions_device(
                            beta if isinstance(beta, torch.Tensor)
                            else torch.as_tensor(
                                beta, dtype=solve_dtype(self.solver_dtype),
                                device=self.device))
                        if "dominant" in self.outputs:
                            # One byte a spot where K allows it, as in JAX.
                            dom = torch.argmax(props_dev, dim=1).to(
                                torch.uint8 if beta.shape[1] <= 256
                                else torch.int32)
                            dominant = fetch_to_host(dom, np.int64)
                        if "proportions" in self.outputs:
                            props = fetch_to_host(
                                self._fetch_cast(props_dev))
                            props_dev = None
        except BaseException:
            # A failed fit must not pin the consume-once operands (on the
            # streamed path an (N, K) device buffer).
            self._clear_consume_once()
            raise

        if device_out:
            host = isinstance(beta, np.ndarray)
            self._beta_host = beta if host else None
            self._beta_dev = None if host else beta
            self._props_host = props
            self._props_dev = props_dev
            self.dominant_ = dominant
        else:
            self.beta_ = beta
            self.proportions_ = normalize_proportions(beta)
            self.dominant_ = None
        self.info_ = info
        self.timings_ = timer.timings
        self._fitted = True
        self._log(f"  converged={info['converged']} after "
                  f"{info['n_iterations']} sweeps")
        if self.verbose:
            print(timer.report())
        return self

    def fit_transform(self, Y: ArrayLike, X: np.ndarray, coords: np.ndarray,
                      **kwargs) -> np.ndarray:
        """Fit (``kwargs`` go to :meth:`fit`) and return the (n_spots,
        n_cell_types) proportions."""
        return self.fit(Y, X, coords, **kwargs).proportions_

    def fit_distributed(
        self,
        Y_local: ArrayLike,
        X: np.ndarray,
        coords_local: np.ndarray,
        cell_type_names: Optional[np.ndarray] = None,
    ) -> "FlashDeconv":
        """One-call multi-process fit: every process passes only its spots.

        Run the same script on every process of a ``torch.distributed`` job
        (after :func:`flashdeconv_tpu_torch.parallel.multihost.initialize`),
        with ``Y_local`` / ``coords_local`` holding process p's contiguous
        block of global spot rows (process 0's rows first, then process
        1's, ...). The full count matrix never exists in one process; per
        stage:

        1. gene selection — per-process O(local nnz) HVG moment passes, one
           cross-process reduction
           (``multihost.distributed_select_informative_genes``);
        2. normalisation + sketch + Xty — the per-process fused native pass
           over the local CSR slice (log-CPM is row-local; pearson's global
           gene means are one reduction), or the staged host pass for
           other input; only the (N, K) Xty rows and the YtY parts are
           gathered;
        3. spatial graph — the coordinates (16 B/spot) are gathered once,
           each process runs the kNN queries of its own rows, and the edge
           lists are gathered and symmetrised
           (``multihost.distributed_adjacency``);
        4. lambda — the replicated closed form;
        5. solve — the spot-sharded solve on ``mesh``, or on
           ``multihost.global_spot_mesh(n_shards or 1, device)``: each
           process holds only its shards' operands, and every process ends
           with the same fitted state (beta gathered to the host in f64).

        The result is bitwise single-process :meth:`fit` on the
        concatenated inputs over the same mesh when the canonical native
        fused path applies (CSR counts and ``log_cpm``); pearson, raw and
        the staged pass agree to f64 rounding (the cross-process sums
        reassociate), and the objective to f64 rounding everywhere (YtY is
        a cross-process sum). ``device_outputs``, ``fetch_dtype`` and
        ``outputs`` are ignored: no process holds the other processes'
        device shards, so the host f64 path runs. The stages run in order
        on one thread, since every process must issue the same collectives
        in the same order. Sets ``host_rows_`` = ``(row_start,
        row_stop)``.

        Without a process group this is the sharded :meth:`fit` over that
        mesh.
        """
        from flashdeconv_tpu_torch.core.solver import sanitize_yty
        from flashdeconv_tpu_torch.parallel import (
            multihost,
            prepare_sharded_bcd,
        )

        timer = StageTimer()
        if sparse.issparse(Y_local) and not sparse.isspmatrix_csr(Y_local):
            Y_local = Y_local.tocsr()
        coords_local = np.asarray(coords_local, dtype=np.float64)
        self._validate(Y_local, X, coords_local, cell_type_names)

        mesh = self.mesh if self.mesh is not None else (
            multihost.global_spot_mesh(self.n_shards or 1, self.device))
        row_start, row_stop, n_global = multihost.process_row_offsets(
            Y_local.shape[0])
        if n_global == 0:
            raise ValueError("fit_distributed requires at least one spot.")
        self._log(f"FlashDeconv (torch, distributed): rows [{row_start}, "
                  f"{row_stop}) of {n_global} spots x {Y_local.shape[1]} "
                  f"genes, {X.shape[0]} cell types")
        self.n_spots_ = n_global
        self.n_genes_ = Y_local.shape[1]
        self.n_cell_types_ = X.shape[0]
        self.cell_type_names_ = cell_type_names
        self.host_rows_ = (row_start, row_stop)
        self._clear_consume_once()
        # Consumed by the solve; while it is set, Xty stays on the host.
        self._distributed_mesh = mesh

        with timer.stage("gene_selection"):
            gene_idx, leverage = (
                multihost.distributed_select_informative_genes(
                    Y_local, X, n_hvg=self.n_hvg,
                    n_markers_per_type=self.n_markers_per_type))
        self.gene_idx_ = gene_idx
        self._log(f"  Selected {len(gene_idx)} genes (HVG + markers)")

        # The signature's normalisation; the counts' is folded into the
        # per-process sketch pass below.
        X_subset = X[:, gene_idx]
        colscale = None
        with timer.stage("preprocess"):
            if self.preprocess == "log_cpm":
                X_tilde = _log_cpm_dense(X_subset)
            elif self.preprocess == "pearson":
                mu = multihost.distributed_subset_col_mean(
                    Y_local, gene_idx) + 1e-6
                colscale = 1.0 / _pearson_sigma(mu)
                X_tilde = _pearson_dense(X_subset)
            else:  # raw
                X_tilde = X_subset.astype(np.float64, copy=False)

        with timer.stage("sketch"), trace("sketch"):
            # The operator is built from the seed alike on every process;
            # each contracts only its own rows.
            op = make_countsketch_op(
                len(gene_idx), self.sketch_dim, leverage_scores=leverage,
                random_state=self.random_state)
            X_sketch = np.asarray(X_tilde @ op.to_csr())
            res = None
            if Y_local.shape[0] > 0 and (
                    native.fused_available(Y_local)
                    if self.preprocess == "log_cpm"
                    else native.colscale_available(Y_local)):
                res = self._fused_xty_feed(Y_local, gene_idx, op, X_sketch,
                                           colscale)
                if not np.isfinite(res[1]):
                    # The poisoned-YtY repair of fit(), row-local: zero this
                    # process's poisoned rows and run the pass again.
                    Y_rep = _zero_poisoned_csr_rows(
                        Y_local, gene_idx,
                        logcpm=self.preprocess == "log_cpm")
                    if Y_rep is not None:
                        res = self._fused_xty_feed(Y_rep, gene_idx, op,
                                                   X_sketch, colscale)
            if res is not None:
                xty_local, yty_local = res
            else:
                # Staged pass (non-CSR or non-float input): subset and
                # normalise the local rows, project, contract. Row-local
                # too; the GEMM may reassociate, so it agrees with the
                # single-process staged path to f64 rounding.
                Y_sub = Y_local[:, gene_idx]
                if sparse.issparse(Y_sub) and not sparse.isspmatrix_csr(
                        Y_sub):
                    Y_sub = Y_sub.tocsr()
                if self.preprocess == "pearson":
                    Y_tilde = (Y_sub.multiply(colscale).tocsr()
                               if sparse.issparse(Y_sub) else
                               np.asarray(Y_sub, dtype=np.float64) * colscale)
                else:
                    Y_tilde, _ = preprocess_data(Y_sub, X_subset,
                                                 self.preprocess)
                Y_sk = Y_tilde @ op.to_csr()
                if sparse.issparse(Y_sk):
                    Y_sk = np.asarray(Y_sk.todense())
                Y_sk = np.asarray(Y_sk, dtype=np.float64)
                xty_local = Y_sk @ X_sketch.T
                yty_local = sanitize_yty(None, Y_sk)
            xty = multihost.allgather_rows(
                np.ascontiguousarray(xty_local, dtype=np.float64))
            yty = float(np.sum(multihost.allgather_rows(
                np.asarray([yty_local], dtype=np.float64))))

        with timer.stage("spatial_graph"):
            A, coords_global = multihost.distributed_adjacency(
                coords_local, method=self.spatial_method,
                k=self.k_neighbors, radius=self.radius)
        self.adjacency_ = A

        with timer.stage("lambda_tuning"):
            if self.lambda_spatial == "auto":
                lambda_ = auto_tune_lambda(None, X_sketch, A)
            else:
                lambda_ = float(self.lambda_spatial)
        self._log(f"  lambda = {lambda_:.4f}")
        self.lambda_used_ = lambda_

        beta_init = None
        if (self.warm_start and self.beta_ is not None
                and self.beta_.shape == (n_global, X.shape[0])):
            beta_init = self.beta_
            self._log("  warm start from the previous beta_")

        with timer.stage("solve"), trace("bcd_solve"):
            beta, info = prepare_sharded_bcd(
                None, X_sketch, A, coords=coords_global,
                mesh=self.__dict__.pop("_distributed_mesh"),
                dtype=self.solver_dtype, verbose=self.verbose, xty=xty,
                yty=yty, device=self.device,
            ).solve(lambda_=lambda_, rho=self.rho_sparsity,
                    max_iter=self.max_iter, tol=self.tol,
                    verbose=self.verbose, beta_init=beta_init)

        self.beta_ = beta
        self.proportions_ = normalize_proportions(beta)
        self.dominant_ = None
        self.info_ = info
        self.timings_ = timer.timings
        self._fitted = True
        self._log(f"  converged={info['converged']} after "
                  f"{info['n_iterations']} sweeps")
        return self

    def fit_lambda_path(self, Y: ArrayLike, X: np.ndarray,
                        coords: np.ndarray,
                        lambdas: Optional[np.ndarray] = None,
                        cell_type_names: Optional[np.ndarray] = None) -> list:
        """Solve along a path of spatial-regularisation strengths.

        Runs stages 1-4 once and prepares the solve once (on one device or
        on the mesh), then solves each lambda in ascending order, each
        solve warm-started from the previous lambda's beta. ``lambdas``
        defaults to the auto-tuned lambda times [0.1, 0.3, 1, 3, 10]. The
        model is left fitted at the last lambda. Returns one dict a lambda:
        {"lambda", "beta", "proportions", "info"} (host f64 arrays).
        """
        timer = StageTimer()
        try:
            Y_sketch, X_sketch, A = self._pipeline_operands(
                Y, X, coords, cell_type_names, timer)
            if lambdas is None:
                base = self._resolve_lambda(Y_sketch, X_sketch, A, timer)
                lambdas = base * np.array([0.1, 0.3, 1.0, 3.0, 10.0])
            lambdas = np.sort(np.asarray(lambdas, dtype=float))
            if lambdas.size == 0:
                raise ValueError("lambdas must be non-empty")
            if lambdas[0] < 0:
                raise ValueError(
                    f"lambdas must be non-negative, got min {lambdas[0]}"
                )
            with timer.stage("solver_prepare"):
                problem = self._prepare(Y_sketch, X_sketch, A, coords)
        except BaseException:
            self._clear_consume_once()
            raise

        results = []
        beta_prev = None
        with timer.stage("solve"), trace("bcd_lambda_path"):
            for lam in lambdas:
                self._log(f"  lambda-path solve at lambda = {lam:.4f}")
                beta, info = problem.solve(
                    lambda_=float(lam), rho=self.rho_sparsity,
                    max_iter=self.max_iter, tol=self.tol,
                    verbose=self.verbose, beta_init=beta_prev,
                )
                beta_prev = beta
                results.append({
                    "lambda": float(lam),
                    "beta": beta,
                    "proportions": normalize_proportions(beta),
                    "info": info,
                })

        last = results[-1]
        self.lambda_used_ = last["lambda"]
        self.beta_ = last["beta"]
        self.proportions_ = last["proportions"]
        # A previous device-output fit's argmax describes that fit.
        self.dominant_ = None
        self.info_ = last["info"]
        self.timings_ = timer.timings
        self._fitted = True
        return results

    def get_cell_type_proportions(self) -> np.ndarray:
        """Normalised proportions; raises if not fitted."""
        self._check_fitted()
        return self.proportions_

    def get_abundances(self) -> np.ndarray:
        """Raw (unnormalised) abundances; raises if not fitted."""
        self._check_fitted()
        return self.beta_

    def get_dominant_cell_type(self) -> np.ndarray:
        """Index of the highest-proportion cell type per spot: the fit's
        device argmax when it fetched one (``outputs`` with "dominant"),
        else the argmax of the (possibly lazily fetched) proportions."""
        self._check_fitted()
        if self.dominant_ is not None:
            return self.dominant_
        return np.argmax(self.proportions_, axis=1)

    def summary(self) -> Dict[str, Any]:
        """Dictionary summary of parameters and fit statistics."""
        if not self._fitted:
            return {"fitted": False}
        return {
            "fitted": True,
            "n_spots": self.n_spots_,
            "n_cell_types": self.n_cell_types_,
            "n_genes_used": len(self.gene_idx_),
            "sketch_dim": self.sketch_dim,
            "lambda_spatial": self.lambda_used_,
            "rho_sparsity": self.rho_sparsity,
            "preprocess_method": self.preprocess,
            "converged": self.info_["converged"],
            "n_iterations": self.info_["n_iterations"],
            "final_objective": self.info_["final_objective"],
        }

    def save(self, path: str) -> None:
        """Checkpoint the fitted state to an ``.npz`` file, under the JAX
        package's keys (either package loads the other's file):
        beta_, proportions_, gene_idx_, lambda_used_, the convergence
        record, the sizes, the adjacency and the cell-type names."""
        self._check_fitted()
        A = self.adjacency_.tocsr() if self.adjacency_ is not None else None
        extra = {}
        if A is not None:
            extra.update(
                adj_data=A.data, adj_indices=A.indices, adj_indptr=A.indptr
            )
        if self.cell_type_names_ is not None:
            extra["cell_type_names"] = np.asarray(self.cell_type_names_)
        np.savez_compressed(
            path,
            beta=self.beta_,
            proportions=self.proportions_,
            gene_idx=self.gene_idx_,
            lambda_used=self.lambda_used_,
            converged=self.info_["converged"],
            n_iterations=self.info_["n_iterations"],
            final_objective=self.info_["final_objective"],
            final_change=self.info_["final_change"],
            n_spots=self.n_spots_,
            n_genes=self.n_genes_,
            n_cell_types=self.n_cell_types_,
            **extra,
        )

    @classmethod
    def load(cls, path: str, **init_kwargs) -> "FlashDeconv":
        """Restore a fitted model from :meth:`save` output (this package's
        or the JAX package's); ``init_kwargs`` go to the constructor
        (``device="cpu"`` on a machine without a card)."""
        data = np.load(path, allow_pickle=False)
        model = cls(**init_kwargs)
        model.beta_ = data["beta"]
        model.proportions_ = data["proportions"]
        model.gene_idx_ = data["gene_idx"]
        model.lambda_used_ = float(data["lambda_used"])
        model.n_spots_ = int(data["n_spots"])
        model.n_genes_ = int(data["n_genes"])
        model.n_cell_types_ = int(data["n_cell_types"])
        model.cell_type_names_ = (
            data["cell_type_names"] if "cell_type_names" in data else None
        )
        if "adj_data" in data:
            n = model.n_spots_
            model.adjacency_ = sparse.csr_matrix(
                (data["adj_data"], data["adj_indices"], data["adj_indptr"]),
                shape=(n, n),
            )
        else:
            model.adjacency_ = None
        model.info_ = {
            "converged": bool(data["converged"]),
            "n_iterations": int(data["n_iterations"]),
            "final_objective": float(data["final_objective"]),
            "objectives": [],
            "final_change": float(data["final_change"]),
        }
        model._fitted = True
        return model

    @property
    def beta_(self):
        """(n_spots, n_cell_types) float64 abundances. On the
        device-outputs path the first access fetches beta (then caches
        the host copy and releases the device tensor)."""
        if self._beta_host is None and self._beta_dev is not None:
            self._beta_host = fetch_to_host(self._beta_dev)
            self._beta_dev = None
        return self._beta_host

    @beta_.setter
    def beta_(self, value):
        self._beta_host = value
        self._beta_dev = None

    @property
    def proportions_(self):
        """(n_spots, n_cell_types) float64 proportions. With
        ``outputs=("dominant",)`` they stay on the device until the first
        access, which fetches them in ``fetch_dtype``."""
        if self._props_host is None and self._props_dev is not None:
            self._props_host = fetch_to_host(
                self._fetch_cast(self._props_dev))
            self._props_dev = None
        return self._props_host

    @proportions_.setter
    def proportions_(self, value):
        self._props_host = value
        self._props_dev = None

    def _fetch_cast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` cast on its device to ``fetch_dtype`` (unchanged when
        unset), so only the narrowed bytes cross to the host."""
        if self.fetch_dtype is None:
            return t
        return t.to(_FETCH_DTYPES[self.fetch_dtype])

    @property
    def _is_sharded(self) -> bool:
        """True when the solve dispatches to the spot-sharded mesh path."""
        return self.mesh is not None or (
            self.n_shards is not None and self.n_shards > 1
        )

    def _clear_consume_once(self):
        """Drop the consume-once operands: the fused Xty / YtY (a device
        tensor on the streamed path), the graph-plan future and
        :meth:`fit_distributed`'s mesh."""
        for name in ("_fused_xty", "_fused_yty", "_graph_plan_future",
                     "_distributed_mesh"):
            self.__dict__.pop(name, None)

    def _check_fitted(self):
        if not self._fitted:
            raise RuntimeError("Model has not been fitted. Call fit() first.")

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

    def __repr__(self) -> str:
        status = "fitted" if self._fitted else "not fitted"
        return (
            f"FlashDeconv(sketch_dim={self.sketch_dim}, "
            f"lambda_spatial={self.lambda_spatial}, "
            f"status={status})"
        )
