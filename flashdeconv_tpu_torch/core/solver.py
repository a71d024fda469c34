"""BCD solver of the port: prepare once on the host, solve on the card.

Counterpart of :mod:`flashdeconv_tpu.core.solver`: the same ``bcd_solve`` /
``prepare_bcd`` / :class:`BCDProblem` contract (rho rescaled by
mean(diag(XtX)), warm start, the ``info`` dict) and the same choice among
three tiers, with the solve in :func:`flashdeconv_tpu_torch.ops.bcd.fused_solve`
on an explicit torch device:

- **fused banded**: a banded graph of at least 8,192 spots, at most 32
  bands within a halo of 8 blocks of 4096 spots, whose remainder of rest
  edges is empty or small (at most 2 % of the edges and 8 a spot, the JAX
  gate) — one fused kernel launch per sweep, the rest edges' sums streamed
  into it (refreshed in plain PyTorch at the touched spots). When only the
  halo fails, near-empty bands are spilled into the rest
  (``cap_sparse_bands``) and the plan is tried again, as the JAX solver
  rescues a grid with a few long-range edges;
- **unfused banded**: a banded graph the fused tier does not take (a
  larger remainder, or a halo the rescue cannot cut) — banded neighbour
  sums plus a rest table in plain PyTorch, then the coordinate-descent
  kernel;
- **gather**: any other graph (not banded, or under 8,192 spots) — a
  degree-capped padded neighbour table with an overflow list for hubs,
  then the coordinate-descent kernel.

At f32 with 1 <= K <= 256 every tier launches its kernel, which runs the
register Gauss-Seidel pass at K <= 32 and the panel pass above, with the
fused tier's 4096-spot block and halo rule at every K. An f64 solve, or
one of K > 256, runs the JAX package's XLA tier instead
(:func:`flashdeconv_tpu_torch.ops.bcd.coordinate_descent`), as the JAX
solver does wherever its Pallas kernels do not take the problem: the
unfused banded form on a banded graph (a grid the fused tier would take
at f32 included), the gather form on any other. The host passes (Gram
matrix, graph decomposition, YtY) are the port's own copies of the JAX
package's functions.

Every solve ends either on the device (``return_device=True``: the
(n_spots, K) beta in the solve dtype, un-padded and un-permuted) or in one
fetch,
:func:`fetch_to_host`: the solve-dtype bytes copy into pinned host memory
in chunks, each cast to f64 on the host while the next one copies — what
the JAX package's ``device_get`` followed by ``np.asarray(..., float64)``
does, with the same bits (f32 to f64 is exact).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu_torch import native
from flashdeconv_tpu_torch.ops.bcd import (
    KERNEL_MAX_BANDS,
    BandedTier,
    FusedBandedTier,
    GatherTier,
    Tier,
    build_fused_rest_tables,
    fused_solve,
    kernel_takes,
    overflow_table,
    scalar,
)
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    adjacency_to_padded_capped,
    banded_split,
    cap_sparse_bands,
)
from flashdeconv_tpu_torch.utils.timing import span

#: Spot-axis block of the fused tier: the carry's pad slabs are h blocks
#: wide and the spot axis is padded to a multiple of it.
FUSED_BLOCK = 4096
#: Largest halo, in blocks, the fused tier takes (as in the JAX planner).
FUSED_MAX_H = 8


def precompute_gram_matrix(X_sketch: np.ndarray) -> np.ndarray:
    """Gram matrix XtX = X_sketch @ X_sketch.T, shape (K, K).

    Raises ``ValueError`` when the Gram matrix comes out non-finite (NaN /
    Inf signatures, or f32 overflow): a poisoned XtX silently drives EVERY
    spot to the uniform fallback, which the reference returns without
    complaint (its clipped Numba update maps NaN to 0) — failing loudly
    here is deliberate; see docs/migration.md.
    """
    XtX = X_sketch @ X_sketch.T
    if not np.all(np.isfinite(XtX)):
        raise ValueError(
            "X_sketch produced a non-finite Gram matrix (NaN/Inf in the "
            "signature matrix, or overflow) — every proportion would "
            "degenerate to uniform. Check the reference signatures and "
            "preprocessing."
        )
    return XtX


def soft_threshold(x: float, threshold: float) -> float:
    """Scalar soft-thresholding prox (host convenience / parity helper)."""
    if x > threshold:
        return x - threshold
    if x < -threshold:
        return x + threshold
    return 0.0


def precompute_XtY(X_sketch: np.ndarray, Y_sketch: np.ndarray) -> np.ndarray:
    """H = X_sketch @ Y_sketch.T, shape (K, N) — computed once per solve."""
    return X_sketch @ Y_sketch.T


def compute_objective(
    beta: np.ndarray,
    H: np.ndarray,
    XtX: np.ndarray,
    YtY: float,
    L: sparse.spmatrix,
    lambda_: float,
    rho: float,
) -> float:
    """Objective via the algebraic expansion (host/numpy reference form).

    0.5*(YtY - 2 Tr(Y^T beta X) + Tr(beta^T beta XtX))
    + 0.5*lambda*Tr(beta^T L beta) + rho*||beta||_1

    The 0.5 on the Laplacian term matches the coordinate-update convention
    used by :func:`bcd_solve` (lambda enters the denominator undoubled).
    """
    cross = float(np.sum(beta * H.T))
    quad = float(np.sum((beta.T @ beta) * XtX))
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)
    spatial = 0.5 * lambda_ * float(np.sum(beta * (L @ beta)))
    sparsity = rho * float(np.sum(np.abs(beta)))
    return fidelity + spatial + sparsity


def sanitize_yty(
    yty: Optional[float], Y_sketch: Optional[np.ndarray]
) -> float:
    """Best-effort YtY of the *sanitized* problem (poisoned rows as zeros).

    Pass ``yty=None`` to compute the Frobenius constant from ``Y_sketch``
    (:func:`flashdeconv_tpu_torch.native.yty_f64`), or a precomputed value
    to sanitize only.

    The row guard makes the SOLVE treat a poisoned spot as a zero
    observation, but the objective's Frobenius constant is reduced from the
    raw sketch — one NaN count would leave ``info["final_objective"]`` NaN
    even though beta and the proportions are finite. When the reduction
    came out non-finite and the sketch rows are available, recompute it
    with the non-finite rows zeroed — the same shape and block-ordered
    reduction as the clean path, so the result is bit-identical to solving
    the explicitly-zeroed input. Bad rows are found with a chunked scan (no
    (N, d) boolean temp) and zeroed in a copy: the caller's array is never
    written. Exact pass-through for finite ``yty``; with no sketch to
    attribute against (precomputed ``yty`` + ``Y_sketch=None``) the caller
    must repair upstream (see ``FlashDeconv._fused_xty_feed``'s
    poisoned-row re-run).
    """
    if yty is None:
        yty = native.yty_f64(Y_sketch)
    if np.isfinite(yty) or Y_sketch is None:
        return float(yty)
    Y_sketch = np.asarray(Y_sketch)
    n, d = Y_sketch.shape
    step = max(1, (1 << 22) // max(d, 1))  # ~4M elements per scan chunk
    bad_parts = [
        np.flatnonzero(~np.isfinite(Y_sketch[a: a + step]).all(axis=1)) + a
        for a in range(0, n, step)
    ]
    bad = (
        np.concatenate(bad_parts) if bad_parts
        else np.zeros(0, dtype=np.int64)
    )
    if bad.size == 0:
        return float(yty)  # reduction overflow, not row poison: keep honest
    Yz = np.array(Y_sketch, copy=True)
    Yz[bad] = 0.0
    return native.yty_f64(Yz)


class GraphDecomposition:
    """Precomputed banded-vs-gather analysis of one adjacency matrix.

    Everything :class:`BCDProblem` derives from ``(A, coords, n_spots)``
    alone — the banded split, the optional scrambled-grid re-sort
    permutation, and the solve-order adjacency. Computing it is a pure
    host pass, so a pipeline can run it on a background thread as soon as
    the spatial graph exists (it depends on neither the sketch nor any
    device state) and hand it to :func:`prepare_bcd` via ``graph_plan=``.
    """

    __slots__ = ("use_banded", "perm", "A_solve", "offsets", "masks",
                 "A_rest")

    def __init__(self, A: sparse.spmatrix, n_spots: int,
                 coords: Optional[np.ndarray] = None):
        self.use_banded = False
        self.perm = None
        self.A_solve = A
        self.offsets = self.masks = self.A_rest = None
        if n_spots < 8192:
            return
        # 32 offsets: grid kNN graphs have ~18 distinct diagonals; capping
        # at 16 strands a few corner edges in the gather remainder, which
        # both adds a gather pass and disqualifies the fully fused kernel.
        offsets_np, masks_np, A_rest = banded_split(
            A, max_offsets=32, min_coverage=0.9
        )
        if (
            offsets_np.size == 0
            and coords is not None
            and np.asarray(coords).ndim == 2
            and np.asarray(coords).shape[1] >= 2
        ):
            cand = np.lexsort(
                (np.asarray(coords)[:, 0], np.asarray(coords)[:, 1])
            )
            A_cand = A.tocsr()[cand][:, cand]
            off_c, masks_c, rest_c = banded_split(
                A_cand, max_offsets=32, min_coverage=0.9
            )
            if off_c.size:
                self.perm = cand
                self.A_solve = A_cand
                offsets_np, masks_np, A_rest = off_c, masks_c, rest_c
        self.offsets, self.masks, self.A_rest = offsets_np, masks_np, A_rest
        self.use_banded = offsets_np.size > 0


def _fused_halo_blocks(offsets: np.ndarray) -> Optional[int]:
    """The fused tier's pad ``h`` (blocks of ``FUSED_BLOCK``) for these band
    offsets, or None when it takes no such band set (more than
    ``KERNEL_MAX_BANDS`` bands, or h > ``FUSED_MAX_H``). It stands for the
    JAX planner, whose VMEM gate has no counterpart on the card."""
    halo = int(np.max(np.abs(offsets)))
    h = max(1, -(-halo // FUSED_BLOCK))
    if h > FUSED_MAX_H or offsets.size > KERNEL_MAX_BANDS:
        return None
    return h


def fused_decomposition(offsets: np.ndarray, masks: np.ndarray,
                        A_rest: sparse.spmatrix, total_nnz: int):
    """The decomposition the fused tier runs, as the JAX ``BCDProblem``
    chooses it: ``(offsets, masks, A_rest, h)``, or None for the unfused
    banded tier.

    The remainder must be small: at most 2 % of the graph's ``total_nnz``
    edges and 8 edges a spot (JAX ``_rest_fusable``). When the bands' halo
    is too wide, near-empty bands are spilled into the remainder
    (:func:`cap_sparse_bands`) and, if that leaves fewer bands and a small
    remainder, planned again — the JAX rescue of a grid with a few
    long-range edges.
    """
    def rest_fusable(rest):
        return rest.nnz == 0 or (
            rest.nnz <= 0.02 * max(int(total_nnz), 1)
            and int(np.diff(rest.tocsr().indptr).max()) <= 8
        )

    if not rest_fusable(A_rest):
        return None
    h = _fused_halo_blocks(offsets)
    if h is not None:
        return offsets, masks, A_rest, h
    off2, masks2, rest2 = cap_sparse_bands(offsets, masks, A_rest,
                                           int(total_nnz))
    if off2.size and off2.size < offsets.size and rest_fusable(rest2):
        h = _fused_halo_blocks(off2)
        if h is not None:
            return off2, masks2, rest2, h
    return None


def _degenerate_result(n_spots: int, n_types: int) -> Tuple[np.ndarray, dict]:
    """Empty-input / zero-iteration fast path (reference ``solver.py:334-343``)."""
    beta = np.full((n_spots, n_types), 1.0 / max(n_types, 1), dtype=np.float64)
    if n_spots == 0 or n_types == 0:
        beta = np.empty((n_spots, n_types), dtype=np.float64)
    return beta, {
        "converged": n_spots == 0 or n_types == 0,
        "n_iterations": 0,
        "final_objective": 0.0,
        "objectives": [],
        "final_change": 0.0,
    }


def info_dict(n_iter: int, rel: float, converged: bool, objectives: list,
              verbose: bool, **extra) -> dict:
    """The ``info`` of a solve that ran sweeps, on a device or a mesh, from
    :func:`flashdeconv_tpu_torch.ops.bcd.run_prepared_solve`'s results:
    the final objective is ``objectives[-1]``, and the objectives are
    listed on the verbose cadence only, as in the JAX solver; ``extra``
    (a mesh's keys) follows."""
    return {
        "converged": converged,
        "n_iterations": int(n_iter),
        "final_objective": objectives[-1],
        "objectives": objectives if verbose else [],
        "final_change": float(rel),
        **extra,
    }


def normalize_proportions(beta: np.ndarray) -> np.ndarray:
    """Row-normalize abundances to proportions; all-zero rows become uniform."""
    beta = np.asarray(beta, dtype=np.float64)
    row_sums = beta.sum(axis=1, keepdims=True)
    zero_rows = (row_sums == 0).ravel()
    proportions = beta / np.maximum(row_sums, 1e-10)
    if np.any(zero_rows):
        proportions[zero_rows] = 1.0 / beta.shape[1]
    return proportions


#: Bytes of one chunk of :func:`fetch_to_host`'s pinned staging ring.
FETCH_CHUNK_BYTES = 1 << 25

_HOST_DTYPES = {np.dtype(np.float64): torch.float64,
                np.dtype(np.int64): torch.int64}

#: The solve dtypes, numpy to torch: f32 (the kernels' and the default) and
#: f64 (the XLA tier at any K).
SOLVE_DTYPES = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def solve_dtype(dtype) -> torch.dtype:
    """The torch dtype of a solve ``dtype`` (float32 or float64)."""
    try:
        return SOLVE_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise ValueError(f"solve dtype must be float32 or float64, got "
                         f"{np.dtype(dtype).name}") from None


def fetch_to_host(t: torch.Tensor, dtype=np.float64,
                  chunk_bytes: int = FETCH_CHUNK_BYTES) -> np.ndarray:
    """``t`` as a host numpy array of ``dtype`` (float64, or int64 for
    indices).

    ``t`` keeps its own dtype on the wire: its bytes copy to the host in
    chunks of ``chunk_bytes`` through two staging buffers, pinned for a
    CUDA tensor, and each chunk is cast into the output on the host (by
    torch, on its threads) while the next one copies. A chunk is read
    only after the event recorded behind its copy has completed, and a
    buffer is refilled only after its last chunk was cast. The values are
    those of ``t.to(dtype)`` (every cast used here is exact or rounds
    once, as on the card), bf16 included, which numpy lacks. A failed pin
    or copy raises.
    """
    src = t.detach().contiguous().reshape(-1)
    out = torch.empty(src.numel(), dtype=_HOST_DTYPES[np.dtype(dtype)])
    step = max(1, chunk_bytes // src.element_size())
    cuda = src.is_cuda
    stage = [torch.empty(min(step, src.numel()), dtype=src.dtype,
                         pin_memory=cuda) for _ in range(2)]

    def copy(i):
        a = i * step
        chunk = src[a:a + step]
        buf = stage[i % 2][:chunk.numel()]
        buf.copy_(chunk, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(src.device))
        return a, buf, event

    n_chunks = -(-src.numel() // step)
    pending = copy(0) if n_chunks else None
    for i in range(n_chunks):
        a, buf, event = pending
        if i + 1 < n_chunks:
            pending = copy(i + 1)
        if event is not None:
            event.synchronize()
        out[a:a + buf.numel()].copy_(buf)
    return out.numpy().reshape(tuple(t.shape))


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class BCDProblem:
    """A prepared solve: the tier's device operands + graph layout.

    Construction does every host pass once — the f64 Gram matrix, the
    banded decomposition (with the coordinate re-sort of scrambled grids),
    the tier's graph operands (band masks, or a degree-capped neighbour
    table with an overflow table), YtY — and copies the operands to
    ``device``: Xty transposed to (K, n_solve), XtX, the degree vector and
    the graph. :meth:`solve` then runs only the device loop. The join (or
    the build) of the graph analysis is the span
    ``flashdeconv.prepare.graph_plan``, the tier's tables and copies
    ``flashdeconv.prepare.tier``.

    Parameters follow :class:`flashdeconv_tpu.core.solver.BCDProblem`
    (``dtype`` float32 or float64, the operands' and the solve's;
    ``max_degree`` caps the gather tier's neighbour table; ``xty`` may be
    an (N, K) tensor, cast and guarded where it lies), plus ``device``
    ("cuda" by default; raises without a card).
    """

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        dtype=np.float32,
        coords: Optional[np.ndarray] = None,
        max_degree: Optional[int] = None,
        graph_plan: Optional[GraphDecomposition] = None,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
        device="cuda",
    ):
        dev = resolve_device(device)
        tdtype = solve_dtype(dtype)
        if Y_sketch is None and (xty is None or yty is None):
            raise ValueError(
                "Y_sketch=None requires both xty and yty precomputed"
            )
        if xty is not None and np.shape(xty) != (
            A.shape[0], int(X_sketch.shape[0])
        ):
            raise ValueError(
                f"xty shape {np.shape(xty)} does not match the adjacency / "
                f"signature dimensions ({A.shape[0]}, {X_sketch.shape[0]})"
            )
        n_spots = int(Y_sketch.shape[0] if Y_sketch is not None
                      else xty.shape[0])
        n_types = int(X_sketch.shape[0])
        self.n_spots, self.n_types = n_spots, n_types
        self.device, self.dtype = dev, tdtype
        self._degenerate = n_spots == 0 or n_types == 0
        if self._degenerate:
            return

        XtX = precompute_gram_matrix(np.asarray(X_sketch, dtype=np.float64))
        if isinstance(xty, torch.Tensor):
            # Already on the card (the pipeline's streamed feed): cast there.
            Xty_raw = xty.to(dev, tdtype)
        else:
            if xty is None:
                xty = Y_sketch @ X_sketch.T
            Xty_raw = torch.from_numpy(
                np.ascontiguousarray(xty, dtype=np.dtype(dtype))
            ).to(dev)

        with span("flashdeconv.prepare.graph_plan"):
            if graph_plan is not None and hasattr(graph_plan, "result"):
                graph_plan = graph_plan.result()
            if graph_plan is None:
                graph_plan = GraphDecomposition(A, n_spots, coords=coords)
        with span("flashdeconv.prepare.tier"):
            A_solve = graph_plan.A_solve.tocsr()
            fused = None
            # The fused tier is a kernel's: f32 with K <= 256 only (JAX plans
            # it only on its Pallas tier).
            if graph_plan.use_banded and kernel_takes(tdtype, n_types):
                fused = fused_decomposition(
                    graph_plan.offsets, graph_plan.masks, graph_plan.A_rest,
                    A_solve.nnz)
            n_solve = (-(-n_spots // FUSED_BLOCK) * FUSED_BLOCK if fused
                       else n_spots)
            # Binary degree (nnz per row): every edge counts 1 in the sweep.
            n_nbrs = np.zeros(n_solve, dtype=np.float32)
            n_nbrs[:n_spots] = np.diff(A_solve.indptr)

            # Non-finite guard on the device: a poisoned spot's Xty row becomes
            # zero (spatially imputed under lambda > 0, uniform otherwise), an
            # exact pass-through for finite rows.
            finite_row = torch.isfinite(Xty_raw).all(dim=1, keepdim=True)
            self._xty_bad = torch.sum(~finite_row)
            Xty = torch.where(finite_row, Xty_raw, torch.zeros((), device=dev))
            del Xty_raw
            inv_perm = None
            if graph_plan.perm is not None:
                Xty = Xty.index_select(
                    0, torch.from_numpy(graph_plan.perm).to(dev)
                )
                inv_perm = np.empty(n_spots, dtype=np.int64)
                inv_perm[graph_plan.perm] = np.arange(n_spots)
            Xty_t = Xty.new_zeros((n_types, n_solve))
            Xty_t[:, :n_spots] = Xty.T
            del Xty

            common = dict(Xty_t=Xty_t, XtX=XtX, nnb=n_nbrs,
                          YtY=sanitize_yty(yty, Y_sketch))
            if fused:
                offsets_np, masks_np, A_rest, h = fused
                masks = np.zeros((offsets_np.size, n_solve), dtype=np.uint8)
                masks[:, :n_spots] = masks_np
                # The rest table padded to n_solve rows with the sentinel
                # n_spots, as the JAX solver builds it.
                rest_nbr = np.full((n_solve, 0), n_spots, dtype=np.int32)
                if A_rest.nnz:
                    table = adjacency_to_padded(A_rest)[0]
                    rest_nbr = np.full((n_solve, table.shape[1]), n_spots,
                                       dtype=np.int32)
                    rest_nbr[:n_spots] = table
                touched, slot_cols = build_fused_rest_tables(
                    rest_nbr, n_spots, h, FUSED_BLOCK)
                tier = self._tier(FusedBandedTier,
                                  masks=self._to_dev(masks, torch.uint8),
                                  offsets=tuple(int(o) for o in offsets_np),
                                  h=h, block=FUSED_BLOCK,
                                  **self._rest_tables(touched, slot_cols),
                                  **common)
            elif graph_plan.use_banded:
                # The unfused sweep multiplies by the masks every band: widen
                # them once, here.
                if graph_plan.A_rest.nnz:
                    rest = adjacency_to_padded(graph_plan.A_rest)[0].T
                else:
                    rest = np.zeros((0, n_spots), dtype=np.int32)
                tier = self._tier(
                    BandedTier, masks=self._to_dev(graph_plan.masks, tdtype),
                    offsets=tuple(int(o) for o in graph_plan.offsets),
                    rest=self._to_dev(rest, torch.int32), **common)
            else:
                nbr, _, ov_src, ov_dst = adjacency_to_padded_capped(
                    A_solve, max_degree=max_degree
                )
                overflow = None
                if ov_src.size:
                    rows, table = overflow_table(ov_src, ov_dst, n_spots)
                    overflow = (self._to_dev(rows, torch.int64),
                                self._to_dev(table, torch.int32))
                tier = self._tier(GatherTier,
                                  nbr=self._to_dev(nbr.T, torch.int32),
                                  overflow=overflow, **common)
            self.perm = graph_plan.perm
            self._attach(tier, mean_diag=float(np.mean(np.diag(XtX))),
                         inv_perm=inv_perm)

    def _to_dev(self, a, dtype) -> torch.Tensor:
        """A contiguous copy of ``a`` on the problem's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, dtype).contiguous()
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=self.device)

    def _rest_tables(self, touched, slot_cols) -> dict:
        """The fused tier's rest-stream tables on the device (int64, the
        index type of ``index_copy_``), or None without rest edges."""
        if touched is None:
            return dict(rest_touched=None, rest_slot_cols=None)
        return dict(rest_touched=self._to_dev(touched, torch.int64),
                    rest_slot_cols=self._to_dev(slot_cols, torch.int64))

    def _tier(self, cls, *, Xty_t, XtX, nnb, YtY, **graph) -> Tier:
        """A ``cls`` tier over device copies of the shared operands, in the
        solve dtype, and the given graph operands."""
        return cls(Xty_t=self._to_dev(Xty_t, self.dtype),
                   XtX=self._to_dev(XtX, self.dtype),
                   nnb=self._to_dev(nnb, self.dtype), YtY=float(YtY),
                   **graph)

    def _attach(self, tier: Tier, *, mean_diag: float, inv_perm):
        """Set the solve-time state."""
        self.tier = tier
        self.use_fused_banded = isinstance(tier, FusedBandedTier)
        self.use_banded = isinstance(tier, (FusedBandedTier, BandedTier))
        self._inv_perm_d = (None if inv_perm is None else torch.as_tensor(
            np.asarray(inv_perm), dtype=torch.int64, device=self.device))
        self.mean_diag = float(mean_diag)
        self.n_solve = int(tier.Xty_t.shape[1])

    @property
    def n_nonfinite_spots(self) -> int:
        """Spots whose Xty row held NaN/Inf and was zeroed at prepare time
        (reading it synchronises with the device)."""
        bad = getattr(self, "_xty_bad", None)
        return 0 if bad is None else int(bad)

    def _beta0(self, beta_init: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        if beta_init is None:
            return None
        if beta_init.shape != (self.n_spots, self.n_types):
            raise ValueError(
                f"beta_init shape {beta_init.shape} does not match "
                f"({self.n_spots}, {self.n_types})"
            )
        np_dtype = np.float32 if self.dtype == torch.float32 else np.float64
        b0 = np.maximum(np.asarray(beta_init, dtype=np_dtype), 0.0)
        if self.perm is not None:
            b0 = b0[self.perm]
        full = np.zeros((self.n_solve, self.n_types), dtype=np_dtype)
        full[: self.n_spots] = b0
        return torch.from_numpy(full).to(self.device)

    def solve(
        self,
        lambda_: float = 0.1,
        rho: float = 0.01,
        max_iter: int = 100,
        tol: float = 1e-4,
        verbose: bool = False,
        beta_init: Optional[np.ndarray] = None,
        return_device: bool = False,
    ) -> Tuple[np.ndarray, Dict]:
        """Run the solve; returns ``(beta (n_spots, K) float64, info)``
        with ``info`` = {"converged", "n_iterations", "final_objective",
        "objectives", "final_change"}. With ``return_device`` beta stays on
        the device: the contiguous (n_spots, K) tensor in the solve dtype,
        un-padded and un-permuted (an empty or zero-sweep problem still
        returns host f64, as in the JAX solver). The call is the span
        ``flashdeconv.solve``."""
        with span("flashdeconv.solve"):
            if self._degenerate or max_iter == 0:
                return _degenerate_result(self.n_spots, self.n_types)
            lam = scalar(lambda_, self.dtype)
            rho_eff = scalar(rho * self.mean_diag, self.dtype)
            beta_d, n_iter, rel, converged, objectives = fused_solve(
                self._beta0(beta_init), self.tier, self._inv_perm_d, lam,
                rho_eff, tol, max_iter, self.n_spots, verbose=verbose,
            )
            # A contiguous copy: the fused tier's beta is a view of its carry.
            beta = (beta_d.contiguous() if return_device
                    else fetch_to_host(beta_d))
            return beta, info_dict(n_iter, rel, converged, objectives,
                                   verbose)


def problem_from_arrays(
    arrays: Dict[str, np.ndarray], *, offsets, h: int, block: int,
    n_spots: int, device="cuda",
) -> BCDProblem:
    """A port :class:`BCDProblem` over operands prepared elsewhere.

    ``arrays`` holds the fused-tier operands of a
    :class:`flashdeconv_tpu.core.solver.BCDProblem` as numpy arrays, under
    its attribute names: ``Xty_t_d`` (K, n_solve), ``XtX_d`` (K, K),
    ``masks_d`` (U, n_solve) uint8, ``nnb_d`` (n_solve,), ``YtY``,
    ``mean_diag``, for a re-sorted graph ``_inv_perm_d`` (n_spots,) and,
    for a graph with rest edges, the rest stream's ``rest_touched_d`` (T,)
    and ``rest_slots_d`` (R, T). The port then solves exactly those
    operands on its fused tier.
    """
    prob = BCDProblem.__new__(BCDProblem)
    K = np.shape(arrays["Xty_t_d"])[0]
    prob.n_spots, prob.n_types = int(n_spots), int(K)
    prob.device = resolve_device(device)
    prob.dtype = torch.float32
    prob._degenerate = False
    prob.perm = None
    inv_perm = arrays.get("_inv_perm_d")
    if inv_perm is not None:
        inv_perm = np.asarray(inv_perm, dtype=np.int64)
        prob.perm = np.empty_like(inv_perm)
        prob.perm[inv_perm] = np.arange(inv_perm.size)
    tier = prob._tier(
        FusedBandedTier, Xty_t=arrays["Xty_t_d"], XtX=arrays["XtX_d"],
        nnb=arrays["nnb_d"], YtY=arrays["YtY"],
        masks=prob._to_dev(arrays["masks_d"], torch.uint8),
        offsets=tuple(int(o) for o in offsets), h=int(h), block=int(block),
        **prob._rest_tables(arrays.get("rest_touched_d"),
                            arrays.get("rest_slots_d")),
    )
    prob._attach(tier, mean_diag=arrays["mean_diag"], inv_perm=inv_perm)
    return prob


def prepare_bcd(
    Y_sketch: Optional[np.ndarray],
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    dtype=np.float32,
    coords: Optional[np.ndarray] = None,
    max_degree: Optional[int] = None,
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    device="cuda",
) -> BCDProblem:
    """Build a :class:`BCDProblem`: host precompute + copy to ``device``."""
    return BCDProblem(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        max_degree=max_degree, graph_plan=graph_plan, xty=xty, yty=yty,
        device=device,
    )


def bcd_solve(
    Y_sketch: Optional[np.ndarray],
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    coords: Optional[np.ndarray] = None,
    max_degree: Optional[int] = None,
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    device="cuda",
    return_device: bool = False,
) -> Tuple[np.ndarray, Dict]:
    """Solve min 0.5||Y - beta X||^2 + 0.5*lambda Tr(beta^T L beta)
    + rho||beta||_1, beta >= 0, on ``device``; parameters as in
    :func:`flashdeconv_tpu.core.solver.bcd_solve` (``xty`` may be a
    tensor; ``return_device`` as in :meth:`BCDProblem.solve`)."""
    n_spots = (Y_sketch if Y_sketch is not None else xty).shape[0]
    n_types = X_sketch.shape[0]
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        return _degenerate_result(n_spots, n_types)
    problem = prepare_bcd(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        max_degree=max_degree, graph_plan=graph_plan, xty=xty, yty=yty,
        device=device,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init, return_device=return_device,
    )


def normalize_proportions_device(beta: torch.Tensor) -> torch.Tensor:
    """Row-normalise abundances on their device, in their dtype; all-zero
    rows become uniform 1/K (the rule of the host ``normalize_proportions``).
    """
    s = torch.sum(beta, dim=1, keepdim=True)
    p = beta / torch.clamp_min(s, 1e-10)
    return torch.where(s == 0.0, torch.full_like(p, 1.0 / beta.shape[1]), p)
