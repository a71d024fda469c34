"""Spot-sharded BCD solve of wholly banded (grid) graphs: the banded mesh.

Counterpart of :mod:`flashdeconv_tpu.parallel.gspmd`, on a
:class:`~flashdeconv_tpu_torch.parallel._runner.Mesh` within one process
or across the processes of a ``torch.distributed`` job. The
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

Where the fused kernel does not take the problem (an f64 or K > 256
solve, or a halo wider than ``FUSED_MAX_H`` blocks or than a shard),
:func:`_gspmd_iterate` forms each shard's banded neighbour sums in plain
PyTorch over a window of its neighbours' columns and runs the pass of
``ops/bcd.gs_pass_fn``: kernel #2 (``coordinate_descent_block``) at f32
with K <= 256, else the XLA tier's ``coordinate_descent``, as the JAX
mesh runs ``coordinate_descent`` off its Pallas tier.
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
    solve_dtype,
)
from flashdeconv_tpu_torch.ops.bcd import (
    KERNEL_MAX_BANDS,
    _banded_neighbor_sum,
    converge,
    full_f32_matmul,
    fused_banded_sweep,
    gs_inv_den,
    gs_pass_fn,
    kernel_takes,
)
from flashdeconv_tpu_torch.parallel._runner import (
    Mesh,
    MeshProblem,
    as_mesh,
    uniform_result,
)
from flashdeconv_tpu_torch.parallel.solver import (
    _prepared_xty,
    default_mesh,
)

# The overlap split's "auto" rule, the JAX package's (n_local <= 16384
# spots, at least 2h + 1 blocks a shard); it is not retuned for this card.
_OVERLAP_AUTO_MAX_LOCAL = 16384


def _window_edges(mesh: Mesh, edges, s: int, halo: int, n_local: int):
    """What shard ``s``'s window of ``halo`` columns each side reads of the
    other shards' ``edges`` (:func:`_shard_edges`), on its card
    (:meth:`Mesh.copy`; queued before any shard's pass of the sweep, so a
    copy from another card waits for nothing of this sweep): ``(left,
    right, zeros_left, zeros_right)``, the columns left and right of its
    own in order, and how many zero columns lie beyond the global ends."""
    left, right = [], []
    need, t = halo, s - 1
    while need > 0 and t >= 0:
        take = min(need, n_local)
        tail = mesh.copy(edges[t][1], t if t in mesh.local else None, s)
        left.insert(0, tail[:, tail.shape[1] - take:])
        need, t = need - take, t - 1
    zeros_left, need, t = need, halo, s + 1
    while need > 0 and t < len(edges):
        take = min(need, n_local)
        head = mesh.copy(edges[t][0], t if t in mesh.local else None, s)
        right.append(head[:, :take])
        need, t = need - take, t + 1
    return left, right, zeros_left, need


def _halo_window(own: torch.Tensor, window) -> torch.Tensor:
    """A shard's beta ``own`` (K, n_local) with ``halo`` columns of the
    global beta each side, (K, halo + n_local + halo) on its device, from
    its :func:`_window_edges`: zero beyond the global ends; ``own`` itself
    where the halo is 0 (a graph without edges)."""
    left, right, zeros_left, zeros_right = window
    if not any(window):
        return own
    K = own.shape[0]
    if zeros_left:
        left = [own.new_zeros((K, zeros_left)), *left]
    if zeros_right:
        right = [*right, own.new_zeros((K, zeros_right))]
    return torch.cat([*left, own, *right], dim=1)


def _shard_edges(mesh: Mesh, betas, halo: int) -> list:
    """Per shard, ``(head, tail)``: its first and last ``min(halo,
    n_local)`` beta columns, all that a window of ``halo`` columns around
    another shard reads of it. This process's shards' are views of
    ``betas`` (None where another process owns the shard); on a mesh that
    spans processes the others' are all-gathered onto the main device."""
    n_local = betas[mesh.local[0]].shape[1]
    w = min(halo, n_local)
    remote = [None] * len(betas)
    if mesh.spans_processes and w > 0:
        remote = mesh.gather_all(mesh.per_shard(lambda s: torch.cat(
            [betas[s][:, :w], betas[s][:, n_local - w:]], dim=1)))
    return [(b[:, :w], b[:, n_local - w:]) if b is not None
            else (r[:, :w], r[:, w:]) for b, r in zip(betas, remote)]


def _gspmd_iterate(betas, spares, Xty_t, masks, gs, tol, max_iter: int,
                   offsets: Tuple[int, ...], halo: int, mesh: Mesh):
    """Sharded solve loop of the unfused banded mesh: per sweep and shard,
    the banded neighbour sums in plain PyTorch, then the shard's pass
    ``gs[s]`` (:func:`~flashdeconv_tpu_torch.ops.bcd.gs_pass_fn`) into its
    spare beta. ``betas``/``spares`` and the operands are per-shard lists
    ((K, n_local); ``masks`` (U, n_local) in the solve dtype). Returns
    ``(betas, spares, n_iterations, rel_change)`` with ``betas`` the
    result."""
    state = [betas, spares]

    def sweep():
        cur, nxt = state
        edges = _shard_edges(mesh, cur, halo)
        mesh.fork()
        n_local = cur[mesh.local[0]].shape[1]
        windows = {s: _window_edges(mesh, edges, s, halo, n_local)
                   for s in mesh.local}
        stats = []
        for s in mesh.local:
            with mesh.on(s):
                ns = _banded_neighbor_sum(_halo_window(cur[s], windows[s]),
                                          masks[s], offsets, halo)
                stats += gs[s](cur[s], Xty_t[s], ns, nxt[s])[1:]
        state.reverse()
        return mesh.join_max(stats)

    n_iter, rel = converge(sweep, tol, max_iter,
                           betas[mesh.local[0]].dtype)
    return state[0], state[1], n_iter, rel


def _refresh_pads(mesh: Mesh, carries, h_cols: int) -> None:
    """Each of this process's shards' carry pads from its neighbours'
    boundary data (the left neighbour's last and the right neighbour's
    first ``h_cols`` data columns), by :meth:`Mesh.copy` onto the shard's
    halo-copy stream; the global ends are not written (they stay zero).
    Within one process the neighbours' carries are read in place; across
    processes every shard's first and last data blocks go through
    :meth:`Mesh.exchange` first."""
    P = len(carries)
    n_local = carries[mesh.local[0]].shape[1] - 2 * h_cols
    if mesh.spans_processes:
        edges = [None] * P
        for s in mesh.local:
            with mesh.on(s, side=True):
                edges[s] = torch.cat(
                    [carries[s][:, h_cols:2 * h_cols],
                     carries[s][:, n_local:n_local + h_cols]], dim=1)
        edges = mesh.exchange(edges, side=True)
        first = [None if e is None else e[:, :h_cols] for e in edges]
        last = [None if e is None else e[:, h_cols:] for e in edges]
    else:
        first = [c[:, h_cols:2 * h_cols] for c in carries]
        last = [c[:, n_local:n_local + h_cols] for c in carries]

    def owner(t):
        """The shard whose stream wrote the edge of shard ``t`` read here:
        ``t``'s own, in place; the exchange's result otherwise."""
        return None if mesh.spans_processes else t

    for s in mesh.local:
        if s > 0:
            mesh.copy(last[s - 1], owner(s - 1), s,
                      out=carries[s][:, :h_cols], side=True)
        if s < P - 1:
            mesh.copy(first[s + 1], owner(s + 1), s,
                      out=carries[s][:, h_cols + n_local:], side=True)


def _gspmd_iterate_fused(carries, spares, Xty_t, XtX, masks, inv_den, lam,
                         rho, tol, max_iter: int, offsets: Tuple[int, ...],
                         h: int, block: int, mesh: Mesh, overlap="auto"):
    """Sharded solve loop over kernel #1 (see the module docstring).

    ``carries``/``spares``: per-shard (K, n_local + 2*h*block) carries, the
    spares' global-end pads zero; ``Xty_t``, ``masks`` (uint8),
    ``inv_den``, ``XtX``: per-shard operands (None where another process
    owns the shard). ``overlap``: ``"auto"`` splits each sweep when a
    shard has at least ``2h + 1`` blocks and ``n_local <= 16384`` (the JAX
    rule) or the mesh spans processes, ``True`` whenever a shard has them,
    ``False`` never. Either way the result is bitwise the same. The pads
    (:func:`_refresh_pads`, across processes through the host) are queued
    after every shard's interior call when the sweep is split. Returns
    ``(carries, spares, n_iterations, rel_change)`` with ``carries`` the
    result.
    """
    hB = h * block
    n_local = Xty_t[mesh.local[0]].shape[1]
    m = n_local // block
    if overlap == "auto":
        split = m >= 2 * h + 1 and (n_local <= _OVERLAP_AUTO_MAX_LOCAL
                                    or mesh.spans_processes)
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
        if split:
            # The interior's windows never reach the pads, so it needs no
            # halo: it is queued before the pads, which run on each shard's
            # second stream; the boundary calls wait for them.
            for s in mesh.local:
                with mesh.on(s):
                    stats += run(s, (h, h, m - 2 * h))
        _refresh_pads(mesh, cur, hB)
        for s in mesh.local:
            mesh.wait_side(s)
            with mesh.on(s):
                if split:
                    stats += run(s, (0, 0, h))
                    stats += run(s, (m - h, m - h, h))
                else:
                    stats += run(s)
        state.reverse()
        return mesh.join_max(stats)

    n_iter, rel = converge(sweep, tol, max_iter, torch.float32)
    return state[0], state[1], n_iter, rel


class GspmdBandedProblem(MeshProblem):
    """A prepared banded-mesh problem: the banded analysis, the host
    precompute (XtX, YtY, Xty) and each shard's operands on its device,
    built once; :meth:`solve` runs only the sweeps. Parameters as the JAX
    ``GspmdBandedProblem`` (``mesh`` a :class:`Mesh` or a sequence of
    devices; ``fused_block`` the fused kernel's block, ``FUSED_BLOCK`` by
    default), plus ``device`` for the default mesh.

    The fused loop takes the problem when the kernels take it (f32, K <=
    256), ``1 <= h <= FUSED_MAX_H`` and ``h * block <= n_local`` (h = the
    halo in blocks, rounded up; the halo must lie in one neighbour shard),
    with the spot axis padded to a multiple of ``n_shards * block``;
    otherwise the unfused loop runs on shards padded to a multiple of
    ``n_shards``. ``use_fused`` says which. ``info`` adds ``n_shards``,
    ``n_bands``, ``halo_width`` and, after sweeps, ``fused_kernel``.
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
        self.dtype = tdtype = solve_dtype(dtype)
        Xty_np, self.n_nonfinite_spots = _prepared_xty(Y_sketch, X_sketch, A,
                                                       xty, yty, dtype)
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
        self.mesh = mesh = (as_mesh(mesh) if mesh is not None
                            else default_mesh(device=device))
        self.n_shards = P = len(mesh)
        self.offsets = tuple(int(o) for o in offsets_np)
        self.halo = max((abs(o) for o in self.offsets), default=0)

        block = int(fused_block) if fused_block is not None else FUSED_BLOCK
        h = -(-self.halo // block)
        n_local_c = -(-n_spots // (P * block)) * block
        self.use_fused = (kernel_takes(tdtype, n_types)
                          and 1 <= h <= FUSED_MAX_H and h * block <= n_local_c
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
        Xty_t = np.zeros((n_types, self.n_pad), Xty_np.dtype)
        Xty_t[:, :n_spots] = Xty_np.T
        XtX = {dev: torch.tensor(XtX64, dtype=tdtype, device=dev)
               for dev in set(mesh.devices)}

        def cols(arr, dtype):
            """Per shard of this process, its columns of ``arr``."""
            return mesh.per_shard(lambda s: torch.from_numpy(
                np.ascontiguousarray(arr[..., s * n_local:(s + 1) * n_local])
            ).to(mesh[s], dtype))

        self.Xty_t = cols(Xty_t, tdtype)
        self.nnb = cols(nnb, tdtype)
        # The fused kernel reads the uint8 masks; the unfused sums multiply
        # by them every band, so they are widened once, here.
        self.masks = cols(masks, torch.uint8 if self.use_fused else tdtype)
        self.XtX = mesh.per_shard(lambda s: XtX[mesh[s]])
        if verbose:
            kernel = ("fused CUDA" if self.use_fused else "CUDA CD"
                      if kernel_takes(tdtype, n_types) else "XLA-tier")
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
            def uniform(s):
                b = torch.zeros((self.n_types, n), dtype=self.dtype,
                                device=self.mesh[s])
                b[:, :max(min(self.n_spots - s * n, n), 0)] = 1.0 / self.n_types
                return b

            return self.mesh.per_shard(uniform)
        b0 = np.zeros((self.n_types, self.n_pad), np.float64)
        b0[:, :self.n_spots] = np.maximum(beta_init, 0.0).T
        return self.mesh.per_shard(lambda s: torch.from_numpy(
            np.ascontiguousarray(b0[:, s * n:(s + 1) * n])
        ).to(self.mesh[s], self.dtype))

    def _state(self, betas) -> list:
        """The loop state of ``betas``; the fused loop's are carries, the
        spares' pads zero."""
        if not self.use_fused:
            return super()._state(betas)
        pad = self._fused_h * self._fused_block
        carries = self.mesh.per_shard(
            lambda s: torch.nn.functional.pad(betas[s], (pad, pad)))
        return [carries,
                self.mesh.per_shard(lambda s: torch.zeros_like(carries[s]))]

    def _data(self, state) -> list:
        """Each shard's (K, n_local) beta of a loop state (views; None
        where another process owns the shard)."""
        pad = self._fused_h * self._fused_block
        return [None if c is None else c[:, pad:pad + self.n_local]
                for c in state]

    def _sweep_ops(self, lam, rho) -> list:
        """Per shard, what one sweep needs beyond the shared operands: the
        fused kernel's reciprocal denominator, or the unfused loop's pass
        (:func:`~flashdeconv_tpu_torch.ops.bcd.gs_pass_fn`)."""
        if self.use_fused:
            return self.mesh.per_shard(
                lambda s: gs_inv_den(self.XtX[s], self.nnb[s], lam))
        return self.mesh.per_shard(
            lambda s: gs_pass_fn(self.XtX[s], self.nnb[s], lam, rho))

    def _iterate(self, state, lam, rho, tol, n, sweep_ops, overlap="auto"):
        if self.use_fused:
            return _gspmd_iterate_fused(
                *state, self.Xty_t, self.XtX, self.masks, sweep_ops, lam, rho,
                tol, n, self.offsets, self._fused_h, self._fused_block,
                self.mesh, overlap=overlap)
        return _gspmd_iterate(
            *state, self.Xty_t, self.masks, sweep_ops, tol, n, self.offsets,
            self.halo, self.mesh)

    def _run(self, lambda_, rho, tol, max_iter: int, overlap="auto"):
        """The sweeps alone from the uniform start, with the fused loop's
        ``overlap`` forced (tests and ``chip_smoke.py`` hold the split
        against the unsplit loop): ``(beta (n_spots, K) on the main
        device, n_iterations, rel_change)``."""
        lam, rho_eff = self._scalars(lambda_, rho)
        state = self._state(self._beta0(None))
        with full_f32_matmul():
            cur, _, it, rel = self._iterate(state, lam, rho_eff, tol,
                                            max_iter,
                                            self._sweep_ops(lam, rho_eff),
                                            overlap=overlap)
        return self._beta(self._data(cur)), it, rel

    def _neighbor_sums(self, betas):
        """After the edges' exchange, each shard's sums (a function of it)."""
        mesh = self.mesh
        edges = _shard_edges(mesh, betas, self.halo)
        mesh.fork()
        windows = {s: _window_edges(mesh, edges, s, self.halo, self.n_local)
                   for s in mesh.local}
        return lambda s: _banded_neighbor_sum(
            _halo_window(betas[s], windows[s]), self.masks[s].to(self.dtype),
            self.offsets, self.halo)

    def _info_keys(self, solved: bool) -> dict:
        keys = dict(n_shards=self.n_shards, n_bands=len(self.offsets),
                    halo_width=self.halo)
        return dict(fused_kernel=self.use_fused, **keys) if solved else keys


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
