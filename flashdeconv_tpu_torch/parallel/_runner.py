"""The mesh and the shared solve tail of the port's sharded solvers.

Counterpart of :mod:`flashdeconv_tpu.parallel._runner`, single-process
only. A :class:`Mesh` is an ordered tuple of torch devices, one per shard;
a device may appear more than once (several shards on one card, or on the
CPU, as the JAX package's tests run several virtual CPU devices). On CUDA
every shard has its own stream, and a second one for the halo copies of
the banded mesh's overlap split. A sweep forks from the main device's
current stream (:meth:`Mesh.fork`), queues each shard's work on its own
streams (:meth:`Mesh.on`) and joins back (:meth:`Mesh.join_max`); the
solve loop reads one pair of statistics per sweep on the host, as the
single-device loop does. Within a sweep the shards write only their own
buffers, and read other shards' buffers only where no shard of that sweep
writes, so fork and join are the only cross-stream orderings needed.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from flashdeconv_tpu_torch.core.solver import resolve_device


class Mesh:
    """An ordered tuple of torch devices, one per shard (see the module
    docstring). All CUDA or all CPU; a CUDA device without an index is the
    current card. Iterates, indexes and has a length like its tuple."""

    def __init__(self, devices: Iterable):
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be all CUDA or all CPU, "
                             f"got {devs}")
        self.devices: Tuple[torch.device, ...] = tuple(devs)
        self.main = devs[0]
        self.cuda = self.main.type == "cuda"
        self._streams = self._side = None

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, s):
        return self.devices[s]

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"

    def _ensure_streams(self) -> None:
        if self._streams is None:
            self._streams = [torch.cuda.Stream(device=d) for d in self.devices]
            self._side = [torch.cuda.Stream(device=d) for d in self.devices]

    def fork(self) -> None:
        """Every shard's streams wait for the work queued so far on the
        main device's current stream."""
        if not self.cuda:
            return
        self._ensure_streams()
        event = torch.cuda.current_stream(self.main).record_event()
        for stream in (*self._streams, *self._side):
            stream.wait_event(event)

    @contextlib.contextmanager
    def on(self, s: int, side: bool = False):
        """Queue the block's work on shard ``s``'s stream (its halo-copy
        stream with ``side``), with its card current."""
        if not self.cuda:
            yield
            return
        self._ensure_streams()
        stream = (self._side if side else self._streams)[s]
        with torch.cuda.device(self.devices[s]), torch.cuda.stream(stream):
            yield

    def wait_side(self, s: int) -> None:
        """Shard ``s``'s stream waits for what its halo-copy stream has
        queued."""
        if self.cuda:
            self._streams[s].wait_stream(self._side[s])

    def join_max(self, stats: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Join; ``stats`` is the flat ``[max_diff, max_abs, max_diff,
        ...]`` of the shards' calls. Returns both maxima over them on the
        main device (``torch.amax`` keeps a NaN, as ``pmax`` does)."""
        vals = torch.stack(self.gather(stats))
        return torch.amax(vals[0::2]), torch.amax(vals[1::2])

    def gather(self, tensors: Sequence[torch.Tensor]):
        """Join, then ``tensors`` on the main device."""
        if self.cuda:
            main = torch.cuda.current_stream(self.main)
            for stream in (*self._streams, *self._side):
                main.wait_stream(stream)
        return [t.to(self.main) for t in tensors]


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a :class:`Mesh` (a Mesh, or a sequence of devices)."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def validate_beta_init(beta_init, n_spots: int, n_types: int) -> None:
    if beta_init is not None and beta_init.shape != (n_spots, n_types):
        raise ValueError(
            f"beta_init shape {beta_init.shape} does not match "
            f"({n_spots}, {n_types})"
        )


def sanitize_xty_rows(xty: np.ndarray) -> Tuple[np.ndarray, int]:
    """An f32 copy of ``xty`` with its non-finite rows zeroed, and their
    count: a poisoned spot becomes a zero observation, as on the
    single-device tiers (``BCDProblem``)."""
    xty = np.array(xty, dtype=np.float32)
    bad = ~np.isfinite(xty).all(axis=1)
    xty[bad] = 0.0
    return xty, int(bad.sum())


def device_unpermute(obj, beta_d: torch.Tensor, perm: np.ndarray,
                     n_spots: int) -> torch.Tensor:
    """Rows of ``beta_d`` (in ``perm`` order) back to the original spot
    order on the device: one gather. The inverse permutation is built once
    and cached on ``obj._inv_perm_d`` (prepared problems are long-lived)."""
    inv = getattr(obj, "_inv_perm_d", None)
    if inv is None or inv.device != beta_d.device:
        inv_np = np.empty(n_spots, dtype=np.int64)
        inv_np[perm] = np.arange(n_spots)
        inv = obj._inv_perm_d = torch.from_numpy(inv_np).to(beta_d.device)
    return beta_d.index_select(0, inv)


def converge(sweep: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
             tol: float, max_iter: int) -> Tuple[int, float]:
    """Run ``sweep()`` (every shard's sweep; returns the max over shards of
    ``(max|delta|, max|beta_old|)``) until ``max_diff / (max_abs + 1e-10)
    < tol``, formed and compared in f32, or ``max_iter`` sweeps: the rule
    and the one host read per sweep of ``ops.bcd.converge_loop``. Returns
    ``(n_iterations, rel_change)``."""
    tol32 = np.float32(tol)
    it, rel = 0, np.float32(np.inf)
    while it < max_iter and rel >= tol32:
        max_diff, max_abs = sweep()
        rel = np.float32((max_diff / (max_abs + 1e-10)).item())
        it += 1
    return it, float(rel)


def run_prepared_solve(
    run_chunk: Callable[[int], Tuple[int, float]],
    eval_objective: Callable[[], torch.Tensor],
    max_iter: int,
    tol: float,
    verbose: bool,
) -> Tuple[int, float, float, bool, list]:
    """The sweeps and the objective of a prepared sharded solve.

    ``run_chunk(n)`` runs up to ``n`` sweeps on the problem's state and
    returns ``(sweeps run, rel_change)``; ``eval_objective()`` the objective
    of the current state. Without ``verbose`` the sweeps run as one chunk
    and the objective is evaluated once; with it they run in chunks that
    end after sweeps 0, 10, 20, ... and at the converged sweep, each
    followed by the objective, printed (the JAX ``chunked_verbose_solve``
    cadence). Returns ``(n_iterations, rel_change, final_objective,
    converged, objectives)``; ``objectives`` is empty without ``verbose``.
    """
    tol32 = np.float32(tol)
    objectives: list = []
    n_iter, rel = 0, float("inf")
    chunk = 1 if verbose else max_iter
    while n_iter < max_iter and not rel < tol32:
        done, rel = run_chunk(min(chunk, max_iter - n_iter))
        n_iter += done
        chunk = 10
        if verbose:
            objectives.append(float(eval_objective()))
            print(f"Iteration {n_iter - 1}: objective = {objectives[-1]:.6f}, "
                  f"rel_change = {rel:.6e}")
    converged = bool(rel < tol32)
    if verbose and converged:
        print(f"Converged at iteration {n_iter - 1}")
    final = objectives[-1] if verbose else float(eval_objective())
    return n_iter, float(rel), final, converged, objectives


def info_dict(n_iter, rel, final_obj, converged, objectives, **extra):
    """The ``info`` contract of the sharded solves."""
    return {
        "converged": converged,
        "n_iterations": int(n_iter),
        "final_objective": final_obj,
        "objectives": objectives,
        "final_change": float(rel),
        **extra,
    }


def uniform_result(n_spots: int, n_types: int,
                   converged: Optional[bool] = None, **extra):
    """The degenerate / zero-iteration result: uniform beta (empty for an
    empty problem) and the info contract with zero sweeps."""
    empty = n_spots == 0 or n_types == 0
    beta = (np.empty((n_spots, n_types)) if empty
            else np.full((n_spots, n_types), 1.0 / n_types))
    return beta, info_dict(0, 0.0, 0.0, empty if converged is None
                           else converged, [], **extra)
