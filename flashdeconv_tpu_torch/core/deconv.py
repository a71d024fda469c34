"""FlashDeconv orchestrator of the port — the array-level API on a torch device.

Counterpart of :class:`flashdeconv_tpu.core.deconv.FlashDeconv` for a
single-device fit on any spatial graph. Stages 1-5 — gene selection,
normalisation, CountSketch (through the native fused Xty pass for CSR
counts; on ``device`` for dense counts, through the CUDA CountSketch kernel
when G >= 4096 and N >= 1024), the spatial graph and the lambda auto-tune —
are the port's own copies of the JAX package's host functions; stage 6 is
the solve of :mod:`flashdeconv_tpu_torch.core.solver` on ``device``, on
whichever of its three tiers the graph takes (fused banded, unfused
banded, gather), or, with ``mesh`` or ``n_shards > 1``, the spot-sharded
solve of :mod:`flashdeconv_tpu_torch.parallel` (banded mesh or halo plan).

Not ported (``ROADMAP.md``): ``fit_distributed`` (multi-process),
``fit_lambda_path``, ``save``/``load``, warm start, and the device-output
knobs (``device_outputs``, ``fetch_dtype``, ``outputs``).
"""

from __future__ import annotations

import concurrent.futures
from typing import Optional, Union

import numpy as np
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
    bcd_solve,
    normalize_proportions,
    resolve_device,
)
from flashdeconv_tpu_torch.core.spatial import auto_tune_lambda
from flashdeconv_tpu_torch.utils.genes import select_informative_genes
from flashdeconv_tpu_torch.utils.graph import coords_to_adjacency
from flashdeconv_tpu_torch.utils.timing import StageTimer

ArrayLike = Union[np.ndarray, sparse.spmatrix]


class FlashDeconv:
    """Spatial-transcriptomics deconvolution with spatial regularisation,
    solved on a torch device.

    Parameters are those of :class:`flashdeconv_tpu.FlashDeconv` that the
    single-process fit uses, plus ``device`` ("cuda" by default; raises
    without a card, "cpu" runs the plain PyTorch sweeps). ``mesh`` (a
    sequence of torch devices, one per shard, a device possibly repeated)
    or ``n_shards > 1`` (the first ``n_shards`` cards, or ``n_shards``
    shards on the CPU with ``device="cpu"``) sends stage 6 to
    :func:`flashdeconv_tpu_torch.parallel.prepare_sharded_bcd`.

    Attributes (after fit): ``beta_``, ``proportions_``, ``gene_idx_``,
    ``info_``, ``lambda_used_``, ``adjacency_`` and ``timings_``.
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
        device="cuda",
        mesh=None,
        n_shards: Optional[int] = None,
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
        self.mesh = mesh
        self.n_shards = n_shards

        self.beta_ = None
        self.proportions_ = None
        self.gene_idx_ = None
        self.info_ = None
        self.lambda_used_ = None
        self.adjacency_ = None
        self.timings_ = None

    def _validate(self, Y, X, coords):
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

    def _sketch(self, Y, X, timer):
        """Stages 1-3. Returns ``(X_sketch, Y_sketch, xty, yty)``: the
        canonical CSR path leaves ``Y_sketch`` None and hands the host
        (N, K) Xty and YtY of the native fused pass instead."""
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
            Y_subset = None if use_fused else Y[:, gene_idx]
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

        with timer.stage("sketch"):
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
                return X_sketch, Y_sketch, None, None
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
                    xty, yty = self._fused_xty_feed(Y_rep, gene_idx, op,
                                                    X_sketch, colscale)
            return X_sketch, None, xty, yty

    def _fused_xty_feed(self, Y, gene_idx, op, X_sketch, colscale=None):
        """Host (N, K) Xty and YtY from the native fused sketch pass; the
        solver copies Xty to the device once."""
        if self.preprocess == "log_cpm":
            res = native.fused_log1pcpm_xty(
                Y, gene_idx, op.buckets, op.weights, op.sketch_dim, X_sketch,
            )
        else:
            res = native.fused_colscale_xty(
                Y, gene_idx, colscale, op.buckets, op.weights,
                op.sketch_dim, X_sketch,
            )
        if res is None:
            raise RuntimeError(
                "native fused xty kernel returned None despite its gate "
                "passing"
            )
        return res

    def fit(self, Y: ArrayLike, X: np.ndarray, coords: np.ndarray
            ) -> "FlashDeconv":
        """Run the full pipeline; stores results on the instance."""
        if sparse.issparse(Y) and not sparse.isspmatrix_csr(Y):
            Y = Y.tocsr()
        coords = np.asarray(coords)
        self._validate(Y, X, coords)
        self._log(f"FlashDeconv (torch, {self.device}): {Y.shape[0]} spots "
                  f"x {Y.shape[1]} genes, {X.shape[0]} cell types")
        timer = StageTimer()

        # The spatial graph and its banded analysis depend only on coords:
        # build them on a background thread while stages 1-3 run.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            graph_f = pool.submit(
                coords_to_adjacency, coords, method=self.spatial_method,
                k=self.k_neighbors, radius=self.radius,
            )
            plan_f = pool.submit(
                lambda: None if self._is_sharded else GraphDecomposition(
                    graph_f.result(), Y.shape[0], coords)
            )
            try:
                X_sketch, Y_sketch, xty, yty = self._sketch(Y, X, timer)
            except BaseException:
                graph_f.cancel()
                plan_f.cancel()
                raise
            with timer.stage("spatial_graph"):
                A = graph_f.result()
                plan = plan_f.result()
        self.adjacency_ = A

        with timer.stage("lambda_tuning"):
            if self.lambda_spatial == "auto":
                lambda_ = auto_tune_lambda(Y_sketch, X_sketch, A)
            else:
                lambda_ = float(self.lambda_spatial)
        self.lambda_used_ = lambda_
        self._log(f"  lambda = {lambda_:.4f}")

        with timer.stage("solve"):
            beta, info = self._solve(Y_sketch, X_sketch, A, coords, lambda_,
                                     plan, xty, yty)
        self.beta_ = beta
        self.proportions_ = normalize_proportions(beta)
        self.info_ = info
        self.timings_ = timer.timings
        self._log(f"  converged={info['converged']} after "
                  f"{info['n_iterations']} sweeps")
        if self.verbose:
            print(timer.report())
        return self

    @property
    def _is_sharded(self) -> bool:
        """True when the solve dispatches to the spot-sharded mesh path."""
        return self.mesh is not None or (
            self.n_shards is not None and self.n_shards > 1
        )

    def _solve(self, Y_sketch, X_sketch, A, coords, lambda_, plan, xty, yty):
        """Stage 6: the single-device solve, or the spot-sharded one."""
        kw = dict(lambda_=lambda_, rho=self.rho_sparsity,
                  max_iter=self.max_iter, tol=self.tol, verbose=self.verbose)
        if not self._is_sharded:
            return bcd_solve(Y_sketch, X_sketch, A, coords=coords,
                             graph_plan=plan, xty=xty, yty=yty,
                             device=self.device, **kw)
        from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd

        self._log("  solving on a spot-sharded mesh")
        problem = prepare_sharded_bcd(
            Y_sketch, X_sketch, A, coords=coords, mesh=self.mesh,
            n_shards=self.n_shards, verbose=self.verbose, xty=xty, yty=yty,
            device=self.device,
        )
        return problem.solve(**kw)

    def fit_transform(self, Y: ArrayLike, X: np.ndarray, coords: np.ndarray
                      ) -> np.ndarray:
        """Fit and return the (n_spots, n_cell_types) proportions."""
        return self.fit(Y, X, coords).proportions_

    def _log(self, msg: str):
        if self.verbose:
            print(msg)
