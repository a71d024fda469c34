"""Spot-sharded BCD solve over a mesh of torch devices: the halo plan.

Counterpart of :mod:`flashdeconv_tpu.parallel.solver`, on a
:class:`~flashdeconv_tpu_torch.parallel._runner.Mesh` within one process
or across the processes of a ``torch.distributed`` job. The
spots are cut into contiguous shards of a Morton order
(:func:`flashdeconv_tpu_torch.parallel.partition.plan_shards`); each sweep
pools every shard's boundary rows (the JAX ``all_gather``,
:func:`_halo_exchange`), forms each shard's neighbour sums over ``[local |
pool | zero]`` in plain PyTorch and runs the Gauss-Seidel pass of
``ops/bcd.gs_pass_fn`` on the shard — the coordinate-descent kernel
(kernel #2) at f32 with K <= 256, the XLA tier's
``ops/bcd.coordinate_descent`` on an f64 or K > 256 solve, as the JAX plan
runs it; the convergence statistics are the max over shards (the JAX
``pmax``). The halo plan takes any graph; a wholly banded one goes to the
banded mesh of :mod:`flashdeconv_tpu_torch.parallel.gspmd` when the
strategy allows.

The iterate is the single-device gather tier's up to the order of the
neighbour slots (the Morton remap reorders them), so the two agree to the
rounding of the solve dtype with the same sweeps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import sparse

from flashdeconv_tpu_torch.core.solver import (
    precompute_gram_matrix,
    resolve_device,
    sanitize_yty,
    solve_dtype,
)
from flashdeconv_tpu_torch.ops.bcd import (
    converge,
    gs_pass_fn,
    neighbor_sum,
    with_sentinel,
)
from flashdeconv_tpu_torch.parallel._runner import (
    Mesh,
    MeshProblem,
    as_mesh,
    device_unpermute,
    sanitize_xty_rows,
    uniform_result,
    validate_beta_init,
)
from flashdeconv_tpu_torch.parallel.partition import (
    ShardPlan,
    halo_fraction,
    plan_shards,
)

# Minimum problem size for the auto-strategy scrambled-grid re-sort attempt
# (the single-device re-sort's gate): below it, the O(nnz) double
# permutation and second banded split cost more than the banded path saves.
RESORT_MIN_SPOTS = 8192


def default_mesh(n_shards: Optional[int] = None, device="cuda") -> Mesh:
    """A mesh over the first ``n_shards`` visible cards (all by default)
    with ``device`` "cuda"; with ``device`` "cpu", ``n_shards`` (default 1)
    shards on the CPU. Raises past the visible cards, and for "cuda"
    without a card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev] * (1 if n_shards is None else max(int(n_shards), 1))
    if n_shards is None:
        n_shards = len(devices)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > len(devices):
        raise ValueError(
            f"Requested {n_shards} shards but only {len(devices)} devices "
            f"are visible."
        )
    return Mesh(devices[:n_shards])


def _halo_exchange(mesh: Mesh, betas, sends) -> dict:
    """Every shard's boundary rows, pooled: ``{device: (K, n_shards *
    halo_width)}``, one pool per distinct device of the mesh (the JAX
    ``all_gather``; across processes through :meth:`Mesh.gather_all`).
    ``betas``: each shard's (K, shard_size) beta; ``sends``: its
    (halo_width,) local rows, padding == shard_size (the zero sentinel
    column). Returns after a join: the pool is made on the main device's
    stream, and copied to each other card (:meth:`Mesh.copy`) for the
    first of its shards."""
    mesh.fork()
    parts = [None] * len(mesh)
    for s in mesh.local:
        with mesh.on(s):
            parts[s] = torch.index_select(with_sentinel(betas[s]), 1,
                                          sends[s])
    pool = torch.cat(mesh.gather_all(parts), dim=1)
    return {dev: mesh.copy(pool, None, mesh.shard_on(dev))
            for dev in set(mesh.devices)}


def _shard_ns(beta, pool, nbr):
    """Neighbour sums of one shard over ``[local | pool]``; the plan's
    padding index is its width, which :func:`neighbor_sum` reads as +0.0."""
    return neighbor_sum(torch.cat([beta, pool], dim=1), nbr)


def _sharded_sweep(mesh: Mesh, betas, spares, ops):
    """One sweep of every shard: halo exchange, neighbour sums, the shard's
    pass ``ops["gs"]`` into ``spares``, the spot mask (padding columns of
    the last shard stay zero), and the max over shards of the
    statistics."""
    pools = _halo_exchange(mesh, betas, ops["send"])
    mesh.fork()
    stats = []
    for s in mesh.local:
        beta = betas[s]
        with mesh.on(s):
            ns = _shard_ns(beta, pools[mesh[s]], ops["nbr"][s])
            out, d, a = ops["gs"][s](beta, ops["Xty_t"][s], ns, spares[s])
            n_valid = ops["n_valid"][s]
            if n_valid < out.shape[1]:
                # Padding columns: zero Xty, degree and beta give a zero
                # update, so neither they nor the statistics change here.
                out[:, n_valid:] = 0.0
            stats += [d, a]
    return mesh.join_max(stats)


def sharded_bcd_solve(
    Y_sketch: np.ndarray,
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    lambda_: float = 0.1,
    rho: float = 0.01,
    max_iter: int = 100,
    tol: float = 1e-4,
    coords: Optional[np.ndarray] = None,
    mesh=None,
    n_shards: Optional[int] = None,
    plan: Optional[ShardPlan] = None,
    order: str = "morton",
    verbose: bool = False,
    dtype=np.float32,
    beta_init: Optional[np.ndarray] = None,
    strategy: str = "auto",
    device="cuda",
) -> Tuple[np.ndarray, dict]:
    """Spot-sharded BCD solve; drop-in for ``core.solver.bcd_solve``.

    Strategies, as in the JAX package: ``"halo"`` (the explicit plan, any
    graph), ``"banded"`` (the banded mesh, wholly banded graphs only,
    :mod:`flashdeconv_tpu_torch.parallel.gspmd`) and ``"auto"`` (banded
    when the graph is wholly banded, after the scrambled-grid re-sort when
    that makes it so, else halo). ``mesh`` is a :class:`Mesh` or a
    sequence of torch devices; without it, :func:`default_mesh` of
    ``n_shards`` on ``device``. Returns beta (n_spots, K) float64 in the
    original spot order and the ``info`` contract with ``n_shards`` and
    ``halo_width``.
    """
    n_spots = Y_sketch.shape[0]
    n_types = X_sketch.shape[0]
    _check_strategy(strategy, plan)
    if n_spots == 0 or n_types == 0 or max_iter == 0:
        mesh = as_mesh(mesh) if mesh is not None else default_mesh(
            n_shards, device)
        return uniform_result(n_spots, n_types, n_shards=len(mesh),
                              halo_width=0)
    problem = prepare_sharded_bcd(
        Y_sketch, X_sketch, A, coords=coords, mesh=mesh, n_shards=n_shards,
        plan=plan, order=order, dtype=dtype, strategy=strategy,
        verbose=verbose, device=device,
    )
    return problem.solve(
        lambda_=lambda_, rho=rho, max_iter=max_iter, tol=tol,
        verbose=verbose, beta_init=beta_init,
    )


class HaloShardedProblem(MeshProblem):
    """A prepared halo-plan problem: the shard plan, the host precompute
    (XtX, YtY, Xty) and each shard's operands on its device, built once;
    :meth:`solve` runs only the sweeps. ``info`` adds ``n_shards`` and
    ``halo_width``. Parameters as the JAX
    ``HaloShardedProblem`` (``mesh`` a :class:`Mesh` or a sequence of
    devices), plus ``device`` for the default mesh. The plan is built
    with ``pad_shard_to=1``: kernel #2 and the XLA tier take any shard
    width."""

    def __init__(
        self,
        Y_sketch: Optional[np.ndarray],
        X_sketch: np.ndarray,
        A: sparse.spmatrix,
        coords: Optional[np.ndarray] = None,
        mesh=None,
        n_shards: Optional[int] = None,
        plan: Optional[ShardPlan] = None,
        order: str = "morton",
        dtype=np.float32,
        verbose: bool = False,
        xty: Optional[np.ndarray] = None,
        yty: Optional[float] = None,
        device="cuda",
    ):
        n_types = int(X_sketch.shape[0])
        self.dtype = tdtype = solve_dtype(dtype)
        Xty_np, self.n_nonfinite_spots = _prepared_xty(Y_sketch, X_sketch, A,
                                                       xty, yty, dtype)
        self.n_spots, self.n_types = Xty_np.shape[0], n_types
        self.mesh = mesh = (as_mesh(mesh) if mesh is not None
                            else default_mesh(n_shards, device))
        self.n_shards = P = len(mesh)
        if plan is None:
            plan = plan_shards(A, P, coords=coords, order=order,
                               pad_shard_to=1)
        if plan.n_shards != P:
            raise ValueError(f"the plan has {plan.n_shards} shards, the mesh "
                             f"{P} devices")
        self.plan = plan
        if verbose:
            print(
                f"Sharded solve: {P} shards x {plan.shard_size} spots, halo "
                f"width {plan.halo_width} "
                f"({100 * halo_fraction(plan):.2f}% of rows exchanged/sweep)"
            )
        XtX64 = precompute_gram_matrix(np.asarray(X_sketch, np.float64))
        self.YtY = sanitize_yty(yty, Y_sketch)
        self.rho_scale = float(np.mean(np.diag(XtX64)))

        S, hw = plan.shard_size, plan.halo_width
        Xty = plan.scatter(Xty_np)
        XtX = {dev: torch.tensor(XtX64, dtype=tdtype, device=dev)
               for dev in set(mesh.devices)}

        def cols(arr, dtype):
            """Per shard of this process, its rows of a padded (n_pad, ...)
            array, transposed to (..., S), on its device."""
            return mesh.per_shard(lambda s: torch.from_numpy(
                np.ascontiguousarray(np.asarray(arr[s * S:(s + 1) * S]).T)
            ).to(mesh[s], dtype))

        self.Xty_t = cols(Xty, tdtype)
        self.nnb = cols(plan.n_nbrs, tdtype)
        self.XtX = mesh.per_shard(lambda s: XtX[mesh[s]])
        self._ops = {
            "Xty_t": self.Xty_t,
            "nbr": cols(plan.nbr_idx, torch.int32),
            "nnb": self.nnb,
            "send": mesh.per_shard(lambda s: torch.from_numpy(
                plan.send_idx[s * hw:(s + 1) * hw].astype(np.int64)
            ).to(mesh[s])),
            "XtX": self.XtX,
            "n_valid": [int(plan.spot_mask[s * S:(s + 1) * S].sum())
                        for s in range(P)],
        }

    def _beta0(self, beta_init) -> List[torch.Tensor]:
        """Each shard's initial beta (K, shard_size): ``beta_init`` clipped
        at 0 in plan order (copied from the host), or uniform 1/K on the
        spots (made on the device); padding zero."""
        plan, K, S = self.plan, self.n_types, self.plan.shard_size
        if beta_init is None:
            def uniform(s):
                b = torch.zeros((K, S), dtype=self.dtype, device=self.mesh[s])
                b[:, :self._ops["n_valid"][s]] = 1.0 / K
                return b

            return self.mesh.per_shard(uniform)
        b0 = plan.scatter(np.maximum(beta_init, 0.0))
        return self.mesh.per_shard(lambda s: torch.from_numpy(
            np.ascontiguousarray(b0[s * S:(s + 1) * S].T)
        ).to(self.mesh[s], self.dtype))

    def _sweep_ops(self, lam, rho) -> dict:
        """The operands of :func:`_sharded_sweep`, each shard's pass
        (``ops/bcd.gs_pass_fn``) included."""
        return dict(self._ops, gs=self.mesh.per_shard(
            lambda s: gs_pass_fn(self.XtX[s], self.nnb[s], lam, rho)))

    def _iterate(self, state, lam, rho, tol, max_iter: int, ops):
        """Sweeps of :func:`_sharded_sweep`, ``state`` swapped in place."""
        def sweep():
            stats = _sharded_sweep(self.mesh, state[0], state[1], ops)
            state.reverse()
            return stats

        n_iter, rel = converge(sweep, tol, max_iter, self.dtype)
        return state[0], state[1], n_iter, rel

    def _neighbor_sums(self, betas):
        """After a halo exchange, each shard's sums (a function of it)."""
        pools = _halo_exchange(self.mesh, betas, self._ops["send"])
        self.mesh.fork()
        return lambda s: _shard_ns(betas[s], pools[self.mesh[s]],
                                   self._ops["nbr"][s])

    def _beta(self, betas) -> torch.Tensor:
        return device_unpermute(self, super()._beta(betas), self.plan.perm,
                                self.n_spots)

    def _info_keys(self, solved: bool) -> dict:
        return dict(n_shards=self.n_shards,
                    halo_width=self.plan.halo_width)


def _prepared_xty(Y_sketch, X_sketch, A, xty, yty, dtype):
    """The (N, K) Xty of a sharded problem in ``dtype``, non-finite rows
    zeroed, and their count; validates the sketch / precomputed-reduction
    inputs as the JAX constructors do."""
    if Y_sketch is None and (xty is None or yty is None):
        raise ValueError(
            "Y_sketch=None requires both xty and yty precomputed."
        )
    n_types = int(X_sketch.shape[0])
    if xty is not None and np.shape(xty) != (A.shape[0], n_types):
        raise ValueError(
            f"xty shape {np.shape(xty)} does not match the adjacency / "
            f"signature dimensions ({A.shape[0]}, {n_types})"
        )
    return sanitize_xty_rows(xty if xty is not None
                             else Y_sketch @ X_sketch.T, dtype)


class ShardedBCDProblem:
    """Strategy-dispatched prepared sharded problem: a
    :class:`~flashdeconv_tpu_torch.parallel.gspmd.GspmdBandedProblem` or a
    :class:`HaloShardedProblem`, plus the scrambled-grid re-sort
    permutation applied at prepare time — beta enters and leaves
    :meth:`solve` (the inner problems' :meth:`MeshProblem.solve`) in the
    original spot order. Built by :func:`prepare_sharded_bcd`."""

    def __init__(self, inner, perm: Optional[np.ndarray] = None):
        self._inner = inner
        self._perm = perm

    @property
    def strategy(self) -> str:
        from flashdeconv_tpu_torch.parallel.gspmd import GspmdBandedProblem

        return ("banded" if isinstance(self._inner, GspmdBandedProblem)
                else "halo")

    @property
    def n_spots(self) -> int:
        return self._inner.n_spots

    @property
    def n_types(self) -> int:
        return self._inner.n_types

    @property
    def mesh(self) -> Mesh:
        return self._inner.mesh

    solve = MeshProblem.solve

    def _solve(self, lambda_, rho, max_iter, tol, verbose, beta_init):
        """The inner problem's sweeps, beta in the original spot order (on
        the device, un-permuted there), or its zero-sweep host result."""
        perm = self._perm
        validate_beta_init(beta_init, self.n_spots, self.n_types)
        if beta_init is not None and perm is not None:
            beta_init = beta_init[perm]
        beta, info = self._inner._solve(lambda_, rho, max_iter, tol, verbose,
                                        beta_init)
        # A zero-sweep solve returns uniform host rows: nothing to permute.
        if isinstance(beta, torch.Tensor) and perm is not None:
            beta = device_unpermute(self, beta, perm, self.n_spots)
        return beta, info


def _check_strategy(strategy: str, plan) -> None:
    if strategy not in ("auto", "halo", "banded"):
        raise ValueError(f"Unknown strategy: {strategy!r}")
    if strategy == "banded" and plan is not None:
        raise ValueError(
            "strategy='banded' does not use a ShardPlan; pass plan only "
            "with strategy='halo' (or 'auto', which skips the banded path "
            "when a plan is given)."
        )


def prepare_sharded_bcd(
    Y_sketch: Optional[np.ndarray],
    X_sketch: np.ndarray,
    A: sparse.spmatrix,
    coords: Optional[np.ndarray] = None,
    mesh=None,
    n_shards: Optional[int] = None,
    plan: Optional[ShardPlan] = None,
    order: str = "morton",
    dtype=np.float32,
    strategy: str = "auto",
    verbose: bool = False,
    xty: Optional[np.ndarray] = None,
    yty: Optional[float] = None,
    device="cuda",
) -> ShardedBCDProblem:
    """Build a :class:`ShardedBCDProblem`: strategy dispatch, graph
    analysis or partition, host precompute and the copy of every shard's
    operands — once. Strategy resolution as :func:`sharded_bcd_solve`:
    ``"banded"`` when the adjacency is wholly banded within 32 offsets
    (for ``"auto"`` with coords at >= ``RESORT_MIN_SPOTS`` spots, also
    after the scrambled-grid re-sort), else the ``"halo"`` plan."""
    _check_strategy(strategy, plan)
    if Y_sketch is None and (xty is None or yty is None):
        raise ValueError(
            "Y_sketch=None requires both xty and yty precomputed "
            "(the sharded solvers consume the sketch only through these "
            "two reductions)."
        )
    n_spots = int(Y_sketch.shape[0] if Y_sketch is not None
                  else np.shape(xty)[0])
    n_types = int(X_sketch.shape[0])
    if n_spots == 0 or n_types == 0:
        raise ValueError(
            "prepare_sharded_bcd requires a non-empty problem "
            f"(got {n_spots} spots x {n_types} cell types)."
        )
    if mesh is None:
        mesh = default_mesh(n_shards, device)

    if strategy in ("auto", "banded") and plan is None:
        from flashdeconv_tpu_torch.parallel.gspmd import GspmdBandedProblem
        from flashdeconv_tpu_torch.utils.graph import banded_split

        # min_coverage=1.0: the (U, N) masks are made only when the graph
        # really is wholly banded.
        split = banded_split(A, max_offsets=32, min_coverage=1.0)
        fully_banded = A.nnz == 0 or (split[0].size > 0
                                      and split[2].nnz == 0)
        if (not fully_banded and coords is not None and strategy == "auto"
                and n_spots >= RESORT_MIN_SPOTS):
            # Scrambled-grid re-sort: a shuffled grid or hex lattice is
            # wholly banded in row-major (y, x) order.
            c = np.asarray(coords)
            if c.ndim == 2 and c.shape[1] >= 2:
                cand = np.lexsort((c[:, 0], c[:, 1]))
                A_cand = A.tocsr()[cand][:, cand]
                split_c = banded_split(A_cand, max_offsets=32,
                                       min_coverage=1.0)
                if split_c[0].size > 0 and split_c[2].nnz == 0:
                    inner = GspmdBandedProblem(
                        Y_sketch[cand] if Y_sketch is not None else None,
                        X_sketch, A_cand, mesh=mesh, dtype=dtype,
                        verbose=verbose, _split=split_c,
                        xty=xty[cand] if xty is not None else None, yty=yty,
                    )
                    return ShardedBCDProblem(inner, perm=cand)
        if strategy == "banded" or fully_banded:
            inner = GspmdBandedProblem(
                Y_sketch, X_sketch, A, mesh=mesh, dtype=dtype,
                verbose=verbose, _split=split, xty=xty, yty=yty,
            )
            return ShardedBCDProblem(inner)

    inner = HaloShardedProblem(
        Y_sketch, X_sketch, A, coords=coords, mesh=mesh, plan=plan,
        order=order, dtype=dtype, verbose=verbose, xty=xty, yty=yty,
    )
    return ShardedBCDProblem(inner)
