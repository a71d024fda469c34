"""The mesh and the shared solve tail of the port's sharded solvers.

Counterpart of :mod:`flashdeconv_tpu.parallel._runner`. A :class:`Mesh` is
an ordered tuple of torch devices, one per shard; a device may appear more
than once (several shards on one card, or on the CPU, as the JAX package's
tests run several virtual CPU devices). On CUDA every shard has its own
stream, and a second one for the halo copies of the banded mesh's overlap
split. A sweep forks from the main device's current stream
(:meth:`Mesh.fork`), queues each shard's work on its own streams
(:meth:`Mesh.on`) and joins back (:meth:`Mesh.join_max`); the solve loop
reads one pair of statistics per sweep on the host, as the single-device
loop does. Within a sweep the shards write only their own buffers, and
read other shards' buffers only where no shard of that sweep writes, so
fork and join are the only cross-stream orderings needed.

A mesh whose shards span processes (``owners``, one ``torch.distributed``
rank per shard; :func:`flashdeconv_tpu_torch.parallel.multihost.
global_spot_mesh` builds it host-major) is the counterpart of a JAX mesh
over several processes' devices: each process holds operands only for the
shards it owns (:attr:`Mesh.local`, the others are None in every
per-shard list), and what the shards exchange travels by
``all_gather`` (:meth:`Mesh.exchange`): through host memory over Gloo, or
on the device under NCCL. Every process gathers the same values in the
same shard order, so the maxima, sums and beta it forms are those of the
single-process mesh, bit for bit.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flashdeconv_tpu_torch.core.solver import fetch_to_host, resolve_device
from flashdeconv_tpu_torch.ops.bcd import rel_change, scalar


def process_count() -> int:
    """The world size of the ``torch.distributed`` default group, 1 when
    no group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group, 0 when no group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


# One Gloo group per NCCL default group, for host tensors (NCCL moves only
# device tensors); created on first use, which every rank reaches in the
# same collective.
_GLOO_GROUPS: dict = {}


def _host_group():
    """The group host tensors travel through: the default group under
    Gloo, else a Gloo group over the same ranks."""
    if dist.get_backend() == "gloo":
        return None
    key = id(dist.distributed_c10d._get_default_group())
    if key not in _GLOO_GROUPS:
        _GLOO_GROUPS[key] = dist.new_group(backend="gloo")
    return _GLOO_GROUPS[key]


def all_gather_host(t: torch.Tensor):
    """Every process's CPU tensor ``t`` (one shape and dtype on all of
    them), in rank order. ``all_gather``, never a reduction: Gloo's MAX
    drops a NaN, and a SUM's order depends on the ranks."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t, group=_host_group())
    return parts


class Mesh:
    """An ordered tuple of torch devices, one per shard (see the module
    docstring). All CUDA or all CPU; a CUDA device without an index is the
    current card. Iterates, indexes and has a length like its tuple.

    ``owners``: the ``torch.distributed`` rank that owns each shard (each
    rank the same number of shards), for a mesh that spans processes; this
    process's shards are :attr:`local`, and a shard another process owns is
    listed with this process's device, which nothing here uses for it.
    Without ``owners`` every shard is this process's.
    """

    def __init__(self, devices: Iterable, owners: Optional[Iterable] = None):
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
        self.owners: Optional[Tuple[int, ...]] = None
        self.local: Tuple[int, ...] = tuple(range(len(devs)))
        if owners is not None:
            owners = tuple(int(r) for r in owners)
            counts = np.bincount(owners) if owners and min(owners) >= 0 else []
            if len(owners) != len(devs) or len(set(counts)) != 1:
                raise ValueError(
                    f"owners must name a rank 0..W-1 for each of the "
                    f"{len(devs)} shards, each rank as often, got {owners}")
            self.owners = owners
            self._by_rank = [[s for s, r in enumerate(owners) if r == rank]
                             for rank in range(len(counts))]
            self.local = tuple(self._by_rank[process_index()]
                               if process_index() < len(counts) else ())
            if not self.local:
                raise ValueError(f"process {process_index()} owns no shard "
                                 f"of the mesh (owners {owners})")
        self.spans_processes = self.owners is not None and len(
            set(self.owners)) > 1
        self.main = devs[self.local[0]]
        self.cuda = self.main.type == "cuda"
        self._streams = self._side = None

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, s):
        return self.devices[s]

    def __repr__(self) -> str:
        owners = "" if self.owners is None else f", owners={self.owners}"
        return f"Mesh({', '.join(str(d) for d in self.devices)}{owners})"

    def per_shard(self, fn: Callable[[int], object]) -> list:
        """A list over the shards: ``fn(s)`` for this process's shards,
        None for the others."""
        return [fn(s) if s in self.local else None
                for s in range(len(self.devices))]

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

    def join(self) -> None:
        """The main device's current stream waits for every shard's
        streams."""
        if self.cuda and self._streams is not None:
            main = torch.cuda.current_stream(self.main)
            for stream in (*self._streams, *self._side):
                main.wait_stream(stream)

    def join_max(self, stats: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Join; ``stats`` is the flat ``[max_diff, max_abs, max_diff,
        ...]`` of this process's shards' calls. Returns both maxima over
        them, and over every process's on a mesh that spans processes, on
        the main device (``torch.amax`` keeps a NaN, as ``pmax`` does)."""
        vals = torch.stack(self.gather(stats))
        if not self.spans_processes:
            return torch.amax(vals[0::2]), torch.amax(vals[1::2])
        pair = torch.stack([torch.amax(vals[0::2]), torch.amax(vals[1::2])])
        pair = torch.amax(torch.stack(self._all_gather(pair)).to(self.main),
                          dim=0)
        return pair[0], pair[1]

    def gather(self, tensors: Sequence[torch.Tensor]):
        """Join, then ``tensors`` on the main device."""
        self.join()
        return [t.to(self.main) for t in tensors]

    def gather_all(self, tensors: Sequence[Optional[torch.Tensor]]) -> list:
        """Join, then every shard's tensor on the main device: ``tensors``
        holds one per shard, None where another process owns it (on a mesh
        that spans processes; all of one shape and dtype there)."""
        if not self.spans_processes:
            return self.gather(tensors)
        self.join()
        return [t.to(self.main) for t in self.exchange(tensors)]

    def exchange(self, tensors: Sequence[Optional[torch.Tensor]],
                 side: bool = False) -> list:
        """Every shard's tensor, from the process that owns it, on a mesh
        that spans processes: ``tensors`` as :meth:`gather_all` takes them.
        Over Gloo each local tensor is copied to the host on the main
        device's current stream, or on its shard's halo-copy stream with
        ``side`` (which then waits for no other stream), and the result is
        CPU tensors; under NCCL a CUDA mesh joins and gathers on the main
        device (no overlap) and its shards' streams wait for the result."""
        local = [tensors[s] for s in self.local]
        if self._device_collectives():
            self.join()
            parts = self._all_gather(torch.stack(
                [t.to(self.main) for t in local]))
            self.fork()
        else:
            host = []
            for s, t in zip(self.local, local):
                with (self.on(s, side=True) if side
                      else contextlib.nullcontext()):
                    host.append(t.to("cpu"))
            parts = self._all_gather(torch.stack(host))
        out = [None] * len(self.devices)
        for shards, part in zip(self._by_rank, parts):
            for s, t in zip(shards, part):
                out[s] = t
        return out

    def _device_collectives(self) -> bool:
        return self.cuda and dist.get_backend() == "nccl"

    def _all_gather(self, t: torch.Tensor) -> list:
        """Every process's ``t``, in rank order: on the device under NCCL
        (a CUDA mesh), else through host memory."""
        if self._device_collectives():
            parts = [torch.empty_like(t) for _ in range(process_count())]
            dist.all_gather(parts, t.contiguous())
            return parts
        return all_gather_host(t.to("cpu"))


def as_mesh(mesh) -> Mesh:
    """``mesh`` as a :class:`Mesh` (a Mesh, or a sequence of devices)."""
    return mesh if isinstance(mesh, Mesh) else Mesh(mesh)


def validate_beta_init(beta_init, n_spots: int, n_types: int) -> None:
    if beta_init is not None and beta_init.shape != (n_spots, n_types):
        raise ValueError(
            f"beta_init shape {beta_init.shape} does not match "
            f"({n_spots}, {n_types})"
        )


def check_return_device(mesh: Mesh, return_device: bool) -> None:
    """``return_device=True`` needs a mesh within one process."""
    if return_device and mesh.spans_processes:
        raise ValueError(
            "return_device=True is not available on a mesh whose shards span "
            "processes: the device beta of the other processes' shards lies "
            "in their memory (the JAX package cannot fetch it from one "
            "process either); solve() returns the whole beta on the host on "
            "every process"
        )


def fetched(result, return_device: bool):
    """``(beta, info)`` of a prepared problem's ``_solve``: a device beta
    made contiguous with ``return_device``, else fetched to host f64; a host
    (zero-sweep) beta as it is."""
    beta, info = result
    if isinstance(beta, torch.Tensor):
        beta = beta.contiguous() if return_device else fetch_to_host(beta)
    return beta, info


def sanitize_xty_rows(xty: np.ndarray, dtype) -> Tuple[np.ndarray, int]:
    """A copy of ``xty`` in ``dtype`` with its non-finite rows zeroed, and
    their count: a poisoned spot becomes a zero observation, as on the
    single-device tiers (``BCDProblem``)."""
    xty = np.array(xty, dtype=dtype)
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
             tol: float, max_iter: int, dtype: torch.dtype
             ) -> Tuple[int, float]:
    """Run ``sweep()`` (every shard's sweep; returns the max over shards of
    ``(max|delta|, max|beta_old|)``) until ``max_diff / (max_abs + 1e-10)
    < tol``, formed and compared in the solve ``dtype``, or ``max_iter``
    sweeps: the rule and the one host read per sweep of
    ``ops.bcd.converge_loop``. Returns ``(n_iterations, rel_change)``."""
    tol_c = scalar(tol, dtype)
    it, rel = 0, float("inf")
    while it < max_iter and rel >= tol_c:
        rel = rel_change(*sweep())
        it += 1
    return it, rel


def run_prepared_solve(
    run_chunk: Callable[[int], Tuple[int, float]],
    eval_objective: Callable[[], torch.Tensor],
    max_iter: int,
    tol: float,
    verbose: bool,
    dtype: torch.dtype,
) -> Tuple[int, float, float, bool, list]:
    """The sweeps and the objective of a prepared sharded solve.

    ``run_chunk(n)`` runs up to ``n`` sweeps on the problem's state and
    returns ``(sweeps run, rel_change)``; ``eval_objective()`` the objective
    of the current state. Without ``verbose`` the sweeps run as one chunk
    (which a NaN statistic ends, as it ends the single-device loops) and
    the objective is evaluated once; with it they run in chunks that end
    after sweeps 0, 10, 20, ... and at the converged sweep, each followed
    by the objective, printed (the JAX ``chunked_verbose_solve`` cadence).
    Returns ``(n_iterations, rel_change, final_objective, converged,
    objectives)``; ``objectives`` is empty without ``verbose``. ``tol`` is
    compared in the solve ``dtype``.
    """
    tol_c = scalar(tol, dtype)
    objectives: list = []
    n_iter, rel = 0, float("inf")
    chunk = 1 if verbose else max_iter
    while n_iter < max_iter and not rel < tol_c:
        done, rel = run_chunk(min(chunk, max_iter - n_iter))
        n_iter += done
        chunk = 10
        if not verbose:
            break
        objectives.append(float(eval_objective()))
        print(f"Iteration {n_iter - 1}: objective = {objectives[-1]:.6f}, "
              f"rel_change = {rel:.6e}")
    converged = bool(rel < tol_c)
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
