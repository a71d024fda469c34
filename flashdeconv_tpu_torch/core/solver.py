"""BCD solver of the port: prepare once on the host, solve on the card.

Counterpart of :mod:`flashdeconv_tpu.core.solver` for the fused banded
tier: the same ``bcd_solve`` / ``prepare_bcd`` / :class:`BCDProblem`
contract (rho rescaled by mean(diag(XtX)), warm start, the ``info`` dict),
with the solve in :func:`flashdeconv_tpu_torch.ops.bcd.fused_solve` on an
explicit torch device. The host passes (Gram matrix, graph decomposition,
YtY) are the JAX package's own functions, imported, so they agree by
construction.

Only the fused banded tier is ported: f32, a graph that is wholly banded
(no remainder edges), a halo of at most 8 blocks of 4096 spots, and
K <= 64. Every other problem raises ``NotImplementedError`` naming the
``ROADMAP.md`` entry that will port it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu.core.solver import (
    GraphDecomposition,
    _degenerate_result,
    precompute_gram_matrix,
    sanitize_yty,
)
from flashdeconv_tpu_torch.ops.bcd import (
    KERNEL_MAX_BANDS,
    KERNEL_MAX_K,
    f32,
    fused_solve,
)

#: Spot-axis block of the fused tier: the carry's pad slabs are h blocks
#: wide and the spot axis is padded to a multiple of it.
FUSED_BLOCK = 4096
#: Largest halo, in blocks, the fused tier takes (as in the JAX planner).
FUSED_MAX_H = 8
#: Smallest problem GraphDecomposition analyses for bands.
BANDED_MIN_SPOTS = 8192


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


def _not_ported(what: str, entry: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to flashdeconv_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: {entry}); use flashdeconv_tpu for this problem"
    )


class BCDProblem:
    """A prepared fused banded solve: device operands + graph layout.

    Construction does every host pass once — the f64 Gram matrix, the
    banded decomposition (with the coordinate re-sort of scrambled grids),
    padding of the spot axis to :data:`FUSED_BLOCK`, YtY — and copies the
    operands to ``device``: Xty transposed to (K, n_solve), XtX, the degree
    vector and the uint8 band masks. :meth:`solve` then runs only the
    device loop.

    Parameters follow :class:`flashdeconv_tpu.core.solver.BCDProblem`,
    plus ``device`` ("cuda" by default; raises without a card).
    """

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        dtype=np.float32,
        coords: Optional[np.ndarray] = None,
        graph_plan: Optional[GraphDecomposition] = None,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
        device="cuda",
    ):
        dev = resolve_device(device)
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
        self.device = dev
        self._degenerate = n_spots == 0 or n_types == 0
        if self._degenerate:
            return
        if np.dtype(dtype) != np.float32:
            raise _not_ported(f"dtype={np.dtype(dtype).name}",
                              "f64 on the GPU")
        if n_types > KERNEL_MAX_K:
            raise _not_ported(f"K = {n_types} > {KERNEL_MAX_K}",
                              "large K (K > 64)")

        XtX = precompute_gram_matrix(np.asarray(X_sketch, dtype=np.float64))
        if xty is None:
            xty = Y_sketch @ X_sketch.T
        Xty_raw = torch.from_numpy(
            np.ascontiguousarray(xty, dtype=np.float32)
        ).to(dev)

        if graph_plan is not None and hasattr(graph_plan, "result"):
            graph_plan = graph_plan.result()
        if graph_plan is None:
            graph_plan = GraphDecomposition(A, n_spots, coords=coords)
        if not graph_plan.use_banded:
            raise _not_ported(
                f"the gather tier (graph not banded, or n_spots = {n_spots} "
                f"< {BANDED_MIN_SPOTS})", "the gather and unfused-banded tiers",
            )
        if graph_plan.A_rest.nnz:
            raise _not_ported(
                f"the rest stream ({graph_plan.A_rest.nnz} edges off the "
                "bands)", "the rest stream and band-cap rescue",
            )
        offsets = tuple(int(o) for o in graph_plan.offsets)
        halo = max(abs(o) for o in offsets)
        h = max(1, -(-halo // FUSED_BLOCK))
        if h > FUSED_MAX_H or len(offsets) > KERNEL_MAX_BANDS:
            raise _not_ported(
                f"a halo of {halo} spots over {len(offsets)} bands",
                "the rest stream and band-cap rescue",
            )

        n_solve = -(-n_spots // FUSED_BLOCK) * FUSED_BLOCK
        # Binary degree (nnz per row): every edge counts 1 in the sweep.
        n_nbrs = np.zeros(n_solve, dtype=np.float32)
        n_nbrs[:n_spots] = np.diff(graph_plan.A_solve.tocsr().indptr)
        masks = np.zeros((len(offsets), n_solve), dtype=np.uint8)
        masks[:, :n_spots] = graph_plan.masks

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
            inv = np.empty(n_spots, dtype=np.int64)
            inv[graph_plan.perm] = np.arange(n_spots)
            inv_perm = inv
        Xty_t = Xty.new_zeros((n_types, n_solve))
        Xty_t[:, :n_spots] = Xty.T
        del Xty

        self.perm = graph_plan.perm
        self._attach(
            Xty_t=Xty_t, XtX=XtX, masks=masks, nnb=n_nbrs,
            YtY=sanitize_yty(yty, Y_sketch),
            mean_diag=float(np.mean(np.diag(XtX))), inv_perm=inv_perm,
            offsets=offsets, h=h, block=FUSED_BLOCK,
        )

    def _attach(self, *, Xty_t, XtX, masks, nnb, YtY, mean_diag, inv_perm,
                offsets, h, block):
        """Set the solve-time state; array operands go to ``self.device``."""
        def to_dev(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(self.device, dtype).contiguous()
            return torch.tensor(np.asarray(a), dtype=dtype,
                                device=self.device)

        self.Xty_t_d = to_dev(Xty_t, torch.float32)
        self.XtX_d = to_dev(XtX, torch.float32)
        self.masks_d = to_dev(masks, torch.uint8)
        self.nnb_d = to_dev(nnb, torch.float32)
        self._inv_perm_d = (None if inv_perm is None
                            else to_dev(inv_perm, torch.int64))
        self.YtY = float(YtY)
        self.mean_diag = float(mean_diag)
        self.offsets = tuple(int(o) for o in offsets)
        self.h_blocks, self.fused_block = int(h), int(block)
        self.n_solve = int(self.Xty_t_d.shape[1])
        self.use_fused_banded = True

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
        b0 = np.maximum(np.asarray(beta_init, dtype=np.float32), 0.0)
        if self.perm is not None:
            b0 = b0[self.perm]
        full = np.zeros((self.n_solve, self.n_types), dtype=np.float32)
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
    ) -> Tuple[np.ndarray, Dict]:
        """Run the fused solve; returns ``(beta (n_spots, K) float64,
        info)`` with ``info`` = {"converged", "n_iterations",
        "final_objective", "objectives", "final_change"}."""
        if self._degenerate or max_iter == 0:
            return _degenerate_result(self.n_spots, self.n_types)
        lam, rho_eff = f32(lambda_), f32(rho * self.mean_diag)
        beta_d, n_iter, rel, converged, objectives = fused_solve(
            self._beta0(beta_init), self.Xty_t_d, self.XtX_d, self.masks_d,
            self.nnb_d, self.YtY, self._inv_perm_d, lam, rho_eff, tol,
            max_iter, self.offsets, self.h_blocks, self.fused_block,
            self.n_spots, verbose=verbose,
        )
        beta = beta_d.to("cpu", torch.float64).numpy()
        return beta, {
            "converged": converged,
            "n_iterations": int(n_iter),
            "final_objective": objectives[-1],
            # sampled on the verbose cadence only, as in the JAX solver
            "objectives": objectives if verbose else [],
            "final_change": float(rel),
        }


def problem_from_arrays(
    arrays: Dict[str, np.ndarray], *, offsets, h: int, block: int,
    n_spots: int, device="cuda",
) -> BCDProblem:
    """A port :class:`BCDProblem` over operands prepared elsewhere.

    ``arrays`` holds the fused-tier operands of a
    :class:`flashdeconv_tpu.core.solver.BCDProblem` as numpy arrays, under
    its attribute names: ``Xty_t_d`` (K, n_solve), ``XtX_d`` (K, K),
    ``masks_d`` (U, n_solve) uint8, ``nnb_d`` (n_solve,), ``YtY``,
    ``mean_diag`` and, for a re-sorted graph, ``_inv_perm_d`` (n_spots,).
    The port then solves exactly those operands.
    """
    prob = BCDProblem.__new__(BCDProblem)
    K = np.shape(arrays["Xty_t_d"])[0]
    prob.n_spots, prob.n_types = int(n_spots), int(K)
    prob.device = resolve_device(device)
    prob._degenerate = False
    prob.perm = None
    inv_perm = arrays.get("_inv_perm_d")
    if inv_perm is not None:
        inv_perm = np.asarray(inv_perm, dtype=np.int64)
        prob.perm = np.empty_like(inv_perm)
        prob.perm[inv_perm] = np.arange(inv_perm.size)
    prob._attach(
        Xty_t=arrays["Xty_t_d"], XtX=arrays["XtX_d"],
        masks=arrays["masks_d"], nnb=arrays["nnb_d"], YtY=arrays["YtY"],
        mean_diag=arrays["mean_diag"], inv_perm=inv_perm, offsets=offsets,
        h=h, block=block,
    )
    return prob


def prepare_bcd(
    Y_sketch: Optional[np.ndarray],
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    dtype=np.float32,
    coords: Optional[np.ndarray] = None,
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    device="cuda",
) -> BCDProblem:
    """Build a :class:`BCDProblem`: host precompute + copy to ``device``."""
    return BCDProblem(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        graph_plan=graph_plan, xty=xty, yty=yty, device=device,
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
    graph_plan: Optional[GraphDecomposition] = None,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    device="cuda",
) -> Tuple[np.ndarray, Dict]:
    """Solve min 0.5||Y - beta X||^2 + 0.5*lambda Tr(beta^T L beta)
    + rho||beta||_1, beta >= 0, on ``device``; parameters as in
    :func:`flashdeconv_tpu.core.solver.bcd_solve`."""
    n_spots = (Y_sketch if Y_sketch is not None else xty).shape[0]
    n_types = X_sketch.shape[0]
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        return _degenerate_result(n_spots, n_types)
    problem = prepare_bcd(
        Y_sketch, X_sketch, A, dtype=dtype, coords=coords,
        graph_plan=graph_plan, xty=xty, yty=yty, device=device,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init,
    )


def normalize_proportions_device(beta: torch.Tensor) -> torch.Tensor:
    """Row-normalise abundances on their device, in their dtype; all-zero
    rows become uniform 1/K (the rule of the host ``normalize_proportions``).
    """
    s = torch.sum(beta, dim=1, keepdim=True)
    p = beta / torch.clamp_min(s, 1e-10)
    return torch.where(s == 0.0, torch.full_like(p, 1.0 / beta.shape[1]), p)
