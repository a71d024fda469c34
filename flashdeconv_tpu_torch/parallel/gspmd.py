"""Spot-sharded BCD solve of wholly banded (grid) graphs: the banded mesh.

Counterpart of :mod:`flashdeconv_tpu.parallel.gspmd`, in one process. The
spot axis is cut into equal contiguous shards, one per mesh device. The
banded neighbour sum reads ``beta[j + off]`` for a few static offsets, so
a shard needs only ``max|off|`` columns of each adjacent shard per sweep.

The fused loop (:func:`_gspmd_iterate_fused`) keeps each shard's beta as a
transposed carry ``(K, h*block + n_local + h*block)``, the fused kernel's
layout, whose ``h``-block pads hold the adjacent shards' boundary blocks:
before each sweep they are refreshed by in-place copies of the neighbours'
first and last ``h`` data blocks (the global ends stay zero), then kernel
#1 (``ops/bcd.fused_banded_sweep``) sweeps the shard into its second carry
(Jacobi: two carries, ping-pong). With the overlap split the sweep is three
calls of the kernel's sub-range form: the interior, whose windows never
reach the pads, is queued first on the shard's stream while the halo copies
run on a second stream; the two boundary calls follow the copies. Every
data column sees the same window and the same per-column arithmetic as in
the single-device fused tier, so the mesh's iterate and sweeps are bitwise
equal to it at any shard count, split or not.

Where the fused kernel does not take the problem (a halo wider than
``FUSED_MAX_H`` blocks or than a shard), :func:`_gspmd_iterate` forms each
shard's banded neighbour sums in plain PyTorch over a window of its
neighbours' columns and launches kernel #2 (``coordinate_descent_block``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu_torch.core.solver import (
    FUSED_BLOCK,
    FUSED_MAX_H,
    precompute_gram_matrix,
    sanitize_yty,
)
from flashdeconv_tpu_torch.ops.bcd import (
    KERNEL_MAX_BANDS,
    coordinate_descent_block,
    f32,
    full_f32_matmul,
    fused_banded_sweep,
    gs_inv_den,
    objective_from_sums,
    objective_sums,
)
from flashdeconv_tpu_torch.parallel._runner import (
    Mesh,
    as_mesh,
    converge,
    info_dict,
    run_prepared_solve,
    uniform_result,
    validate_beta_init,
)
from flashdeconv_tpu_torch.parallel.solver import (
    _check_solvable,
    _prepared_xty,
    default_mesh,
)

# The overlap split's "auto" rule, the JAX package's (n_local <= 16384
# spots, at least 2h + 1 blocks a shard); it is not retuned for this card.
_OVERLAP_AUTO_MAX_LOCAL = 16384


def _window(betas, s: int, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of the global (K, P * n_local) beta held by the
    shards' ``betas`` (each (K, n_local)), zero outside it, on shard
    ``s``'s device."""
    n_local = betas[0].shape[1]
    total = len(betas) * n_local
    dev = betas[s].device
    parts = []
    if lo < 0:
        parts.append(betas[s].new_zeros((betas[s].shape[0], -lo)))
    c = max(lo, 0)
    while c < min(hi, total):
        t, off = divmod(c, n_local)
        e = min(hi, (t + 1) * n_local)
        parts.append(betas[t][:, off:off + e - c].to(dev))
        c = e
    if hi > total:
        parts.append(betas[s].new_zeros((betas[s].shape[0], hi - total)))
    return torch.cat(parts, dim=1)


def _banded_ns_window(betas, s: int, offsets, masks, halo: int):
    """Shard ``s``'s banded neighbour sums (K, n_local): bands in
    ``offsets`` order from zero, ``masks[u] * beta[j + off]`` over a window
    of ``halo`` neighbour columns each side (the masks are 0 where ``j +
    off`` leaves the problem), as ``ops.bcd.neighbor_sum_banded`` sums."""
    n_local = betas[s].shape[1]
    ns = torch.zeros_like(betas[s])
    if not offsets:
        return ns
    ext = _window(betas, s, s * n_local - halo, (s + 1) * n_local + halo)
    for u, off in enumerate(offsets):
        ns += masks[u] * ext[:, halo + off:halo + off + n_local]
    return ns


def _gspmd_iterate(betas, spares, Xty_t, XtX, masks, inv_den, lam, rho, tol,
                   max_iter: int, offsets: Tuple[int, ...], halo: int,
                   mesh: Mesh):
    """Sharded solve loop of the unfused banded mesh: per sweep and shard,
    the banded neighbour sums in plain PyTorch, then kernel #2 into the
    shard's spare beta. ``betas``/``spares`` and the operands are per-shard
    lists ((K, n_local); ``masks`` f32 (U, n_local)). Returns ``(betas,
    spares, n_iterations, rel_change)`` with ``betas`` the result."""
    state = [betas, spares]

    def sweep():
        cur, nxt = state
        mesh.fork()
        stats = []
        for s in range(len(cur)):
            with mesh.on(s):
                ns = _banded_ns_window(cur, s, offsets, masks[s], halo)
                stats += coordinate_descent_block(
                    cur[s], Xty_t[s], XtX[s], ns, inv_den[s], lam, rho,
                    out=nxt[s])[1:]
        state.reverse()
        return mesh.join_max(stats)

    n_iter, rel = converge(sweep, tol, max_iter)
    return state[0], state[1], n_iter, rel


def _refresh_pads(carries, s: int, h_cols: int) -> None:
    """Shard ``s``'s carry pads from its neighbours' boundary data: the
    left neighbour's last and the right neighbour's first ``h_cols``
    columns. The global ends are not written (they stay zero)."""
    n_local = carries[s].shape[1] - 2 * h_cols
    if s > 0:
        carries[s][:, :h_cols].copy_(carries[s - 1][:, n_local:n_local
                                                    + h_cols])
    if s < len(carries) - 1:
        carries[s][:, h_cols + n_local:].copy_(
            carries[s + 1][:, h_cols:2 * h_cols])


def _gspmd_iterate_fused(carries, spares, Xty_t, XtX, masks, inv_den, lam,
                         rho, tol, max_iter: int, offsets: Tuple[int, ...],
                         h: int, block: int, mesh: Mesh, overlap="auto"):
    """Sharded solve loop over kernel #1 (see the module docstring).

    ``carries``/``spares``: per-shard (K, n_local + 2*h*block) carries, the
    spares' global-end pads zero; ``Xty_t``, ``masks`` (uint8),
    ``inv_den``, ``XtX``: per-shard operands. ``overlap``: ``"auto"``
    splits each sweep when ``n_local <= 16384`` and a shard has at least
    ``2h + 1`` blocks (the JAX rule), ``True`` whenever it has, ``False``
    never. Either way the result is bitwise the same. Returns ``(carries,
    spares, n_iterations, rel_change)`` with ``carries`` the result.
    """
    hB = h * block
    n_local = Xty_t[0].shape[1]
    m = n_local // block
    if overlap == "auto":
        split = n_local <= _OVERLAP_AUTO_MAX_LOCAL and m >= 2 * h + 1
    else:
        split = bool(overlap) and m >= 2 * h + 1
    state = [carries, spares]

    def run(s, sub=None):
        cur, nxt = state
        return fused_banded_sweep(
            cur[s], Xty_t[s], XtX[s], masks[s], inv_den[s], lam, rho,
            offsets, h, block, out=nxt[s], sub=sub)[1:]

    def sweep():
        cur = state[0]
        mesh.fork()
        stats = []
        for s in range(len(cur)):
            if split:
                # The interior's windows never reach the pads, so it needs
                # no halo: it is queued before the copies, which run on the
                # shard's second stream; the boundary calls wait for them.
                with mesh.on(s):
                    stats += run(s, (h, h, m - 2 * h))
                with mesh.on(s, side=True):
                    _refresh_pads(cur, s, hB)
                mesh.wait_side(s)
                with mesh.on(s):
                    stats += run(s, (0, 0, h))
                    stats += run(s, (m - h, m - h, h))
            else:
                with mesh.on(s):
                    _refresh_pads(cur, s, hB)
                    stats += run(s)
        state.reverse()
        return mesh.join_max(stats)

    n_iter, rel = converge(sweep, tol, max_iter)
    return state[0], state[1], n_iter, rel


class GspmdBandedProblem:
    """A prepared banded-mesh problem: the banded analysis, the host
    precompute (XtX, YtY, Xty) and each shard's operands on its device,
    built once; :meth:`solve` runs only the sweeps. Parameters as the JAX
    ``GspmdBandedProblem`` (``mesh`` a :class:`Mesh` or a sequence of
    devices; ``fused_block`` the fused kernel's block, ``FUSED_BLOCK`` by
    default), plus ``device`` for the default mesh.

    The fused loop takes the problem when ``1 <= h <= FUSED_MAX_H`` and
    ``h * block <= n_local`` (h = the halo in blocks, rounded up; the halo
    must lie in one neighbour shard), with the spot axis padded to a
    multiple of ``n_shards * block``; otherwise the unfused loop runs on
    shards padded to a multiple of ``n_shards``. ``use_fused`` says which.
    Raises ``ValueError`` if the graph is not wholly banded within 32
    offsets: use the halo plan then.
    """

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        mesh=None,
        dtype=np.float32,
        verbose: bool = False,
        _split=None,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
        fused_block: Optional[int] = None,
        device="cuda",
    ):
        from flashdeconv_tpu_torch.utils.graph import banded_split

        n_types = int(X_sketch.shape[0])
        Xty_np, self.n_nonfinite_spots = _prepared_xty(Y_sketch, X_sketch, A,
                                                       xty, yty)
        n_spots = Xty_np.shape[0]
        self.n_spots, self.n_types = n_spots, n_types
        offsets_np, masks_np, A_rest = (
            _split if _split is not None else banded_split(A, max_offsets=32)
        )
        if A.nnz > 0 and (offsets_np.size == 0 or A_rest.nnz > 0):
            raise ValueError(
                "Graph is not fully banded; use sharded_bcd_solve instead "
                f"(rest edges: {A_rest.nnz})."
            )
        _check_solvable(dtype, n_types)
        self.mesh = mesh = (as_mesh(mesh) if mesh is not None
                            else default_mesh(device=device))
        self.n_shards = P = len(mesh)
        self.offsets = tuple(int(o) for o in offsets_np)
        self.halo = max((abs(o) for o in self.offsets), default=0)

        block = int(fused_block) if fused_block is not None else FUSED_BLOCK
        h = -(-self.halo // block)
        n_local_c = -(-n_spots // (P * block)) * block
        self.use_fused = (1 <= h <= FUSED_MAX_H and h * block <= n_local_c
                          and len(self.offsets) <= KERNEL_MAX_BANDS)
        if not self.use_fused:
            block, h = 1, 0
        self._fused_h, self._fused_block = h, block
        self.n_pad = -(-n_spots // (P * block)) * (P * block)
        self.n_local = n_local = self.n_pad // P

        XtX64 = precompute_gram_matrix(np.asarray(X_sketch, np.float64))
        self.YtY = sanitize_yty(yty, Y_sketch)
        self.rho_scale = float(np.mean(np.diag(XtX64)))
        # Binary degree (nnz per row): every edge counts 1 in the sweep.
        nnb = np.zeros(self.n_pad, np.float32)
        nnb[:n_spots] = np.diff(A.tocsr().indptr)
        masks = np.zeros((len(self.offsets), self.n_pad), np.uint8)
        masks[:, :n_spots] = masks_np
        Xty_t = np.zeros((n_types, self.n_pad), np.float32)
        Xty_t[:, :n_spots] = Xty_np.T
        XtX = {dev: torch.tensor(XtX64, dtype=torch.float32, device=dev)
               for dev in set(mesh.devices)}

        def cols(arr, s, dtype):
            part = np.ascontiguousarray(arr[..., s * n_local:(s + 1) * n_local])
            return torch.from_numpy(part).to(mesh[s], dtype)

        self.Xty_t = [cols(Xty_t, s, torch.float32) for s in range(P)]
        self.nnb = [cols(nnb, s, torch.float32) for s in range(P)]
        # The fused kernel reads the uint8 masks; the unfused sums multiply
        # by them every band, so they are widened once, here.
        self.masks = [cols(masks, s, torch.uint8 if self.use_fused
                           else torch.float32) for s in range(P)]
        self.XtX = [XtX[mesh[s]] for s in range(P)]
        if verbose:
            kernel = "fused CUDA" if self.use_fused else "CUDA CD"
            print(
                f"GSPMD banded solve: {P} shards x {n_local} spots, "
                f"{len(self.offsets)} bands, halo {self.halo}, {kernel} "
                "sweep kernel"
            )

    def _beta0(self, beta_init) -> List[torch.Tensor]:
        """Each shard's initial beta (K, n_local): ``beta_init`` clipped at
        0 (copied from the host), or uniform 1/K on the spots (made on the
        device); padding zero."""
        n = self.n_local
        if beta_init is None:
            out = []
            for s in range(self.n_shards):
                b = torch.zeros((self.n_types, n), device=self.mesh[s])
                b[:, :max(min(self.n_spots - s * n, n), 0)] = 1.0 / self.n_types
                out.append(b)
            return out
        b0 = np.zeros((self.n_types, self.n_pad), np.float32)
        b0[:, :self.n_spots] = np.maximum(beta_init, 0.0).T
        return [torch.from_numpy(np.ascontiguousarray(b0[:, s * n:(s + 1) * n]))
                .to(self.mesh[s]) for s in range(self.n_shards)]

    def _state(self, betas) -> list:
        """The loop state of ``betas``: ``[current, spare]`` per-shard
        buffers (the fused loop's carries, the spares' pads zero)."""
        if not self.use_fused:
            return [betas, [torch.empty_like(b) for b in betas]]
        pad = self._fused_h * self._fused_block
        carries = [torch.nn.functional.pad(b, (pad, pad)) for b in betas]
        return [carries, [torch.zeros_like(c) for c in carries]]

    def _data(self, state) -> list:
        """Each shard's (K, n_local) beta of a loop state (views)."""
        pad = self._fused_h * self._fused_block
        return [c[:, pad:pad + self.n_local] for c in state]

    def _inv_den(self, lam) -> list:
        return [gs_inv_den(x, n, lam) for x, n in zip(self.XtX, self.nnb)]

    def _iterate(self, state, lam, rho, tol, n, inv_den, overlap="auto"):
        if self.use_fused:
            return _gspmd_iterate_fused(
                *state, self.Xty_t, self.XtX, self.masks, inv_den, lam, rho,
                tol, n, self.offsets, self._fused_h, self._fused_block,
                self.mesh, overlap=overlap)
        return _gspmd_iterate(
            *state, self.Xty_t, self.XtX, self.masks, inv_den, lam, rho, tol,
            n, self.offsets, self.halo, self.mesh)

    def _run(self, lambda_, rho, tol, max_iter: int, overlap="auto"):
        """The sweeps alone from the uniform start, with the fused loop's
        ``overlap`` forced (tests and ``chip_smoke.py`` hold the split
        against the unsplit loop): ``(beta (n_spots, K) f32 on the main
        device, n_iterations, rel_change)``."""
        lam, rho_eff = f32(lambda_), f32(rho * self.rho_scale)
        state = self._state(self._beta0(None))
        with full_f32_matmul():
            cur, _, it, rel = self._iterate(state, lam, rho_eff, tol,
                                            max_iter, self._inv_den(lam),
                                            overlap=overlap)
        beta = torch.cat(self.mesh.gather(self._data(cur)), dim=1)
        return beta[:, :self.n_spots].T, it, rel

    def _objective(self, betas, lam, rho) -> torch.Tensor:
        """The objective: each shard's sums over its own columns, added on
        the main device."""
        mesh = self.mesh
        mesh.fork()
        sums, btbs = [], []
        for s in range(self.n_shards):
            with mesh.on(s):
                ns = _banded_ns_window(betas, s, self.offsets,
                                       self.masks[s].float(), self.halo)
                sm, btb = objective_sums(betas[s], self.Xty_t[s], ns,
                                         self.nnb[s])
                sums.append(sm)
                btbs.append(btb)
        sums, btbs = mesh.gather(sums), mesh.gather(btbs)
        return objective_from_sums(torch.stack(sums).sum(0),
                                   torch.stack(btbs).sum(0), self.XtX[0],
                                   self.YtY, lam, rho)

    def solve(
        self,
        lambda_: float = 0.1,
        rho: float = 0.01,
        max_iter: int = 100,
        tol: float = 1e-4,
        verbose: bool = False,
        beta_init: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, dict]:
        """Run the sweeps; returns ``(beta (n_spots, K) float64, info)``
        with ``n_shards``, ``n_bands``, ``halo_width`` and
        ``fused_kernel``."""
        extra = dict(n_shards=self.n_shards, n_bands=len(self.offsets),
                     halo_width=self.halo)
        if max_iter == 0:
            return uniform_result(self.n_spots, self.n_types,
                                  converged=False, **extra)
        validate_beta_init(beta_init, self.n_spots, self.n_types)
        lam, rho_eff = f32(lambda_), f32(rho * self.rho_scale)
        state = self._state(self._beta0(beta_init))
        with full_f32_matmul():
            inv_den = self._inv_den(lam)

            def run_chunk(n):
                cur, spare, it, rel = self._iterate(state, lam, rho_eff, tol,
                                                    n, inv_den)
                state[:] = [cur, spare]
                return it, rel

            n_iter, rel, final_obj, converged, objectives = (
                run_prepared_solve(
                    run_chunk,
                    lambda: self._objective(self._data(state[0]), lam,
                                            rho_eff),
                    max_iter, tol, verbose))
            beta_d = torch.cat(self.mesh.gather(self._data(state[0])),
                               dim=1)[:, :self.n_spots].T
        beta = beta_d.to("cpu", torch.float64).numpy()
        return beta, info_dict(n_iter, rel, final_obj, converged, objectives,
                               fused_kernel=self.use_fused, **extra)


def gspmd_banded_solve(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    mesh=None,
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    _split=None,
    device="cuda",
) -> Tuple[np.ndarray, dict]:
    """One-shot banded-mesh solve: a :class:`GspmdBandedProblem`, solved.
    Raises ``ValueError`` if the graph is not wholly banded within 32
    offsets (use ``sharded_bcd_solve``'s halo plan then)."""
    n_spots, n_types = Y_sketch.shape[0], X_sketch.shape[0]
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        n_shards = 1 if mesh is None else len(as_mesh(mesh))
        return uniform_result(n_spots, n_types, n_shards=n_shards,
                              n_bands=0, halo_width=0)
    problem = GspmdBandedProblem(
        Y_sketch, X_sketch, A, mesh=mesh, dtype=dtype, verbose=verbose,
        _split=_split, device=device,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init,
    )
