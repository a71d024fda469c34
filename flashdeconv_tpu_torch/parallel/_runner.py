"""The mesh and the one solve of the port's sharded solvers
(:class:`MeshProblem`).

Counterpart of :mod:`flashdeconv_tpu.parallel._runner`. A :class:`Mesh` is
an ordered tuple of torch devices, one per shard; a device may appear more
than once (several shards on one card, or on the CPU, as the JAX package's
tests run several virtual CPU devices). On CUDA every shard has its own
stream, and a second one for the halo copies of the banded mesh's overlap
split. A sweep forks from the main device's current stream, and from each
other card's, where that card's operands were made (:meth:`Mesh.fork`),
queues each shard's work on its own streams (:meth:`Mesh.on`) and joins
back (:meth:`Mesh.join_max`); the solve loop is the single-device one
(``ops.bcd.converge`` under ``ops.bcd.run_prepared_solve``) and reads one
pair of statistics per sweep on the host. Within a sweep the
shards write only their own buffers, and read other shards' buffers only
where no shard of that sweep writes. A tensor that moves between two
cards goes through :meth:`Mesh.copy`, which orders the copy on the
streams that own the data (ATen would run it on the source card's current
stream); on one card it is the plain copy on the destination shard's
stream.

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

from flashdeconv_tpu_torch.core.solver import (
    _degenerate_result,
    fetch_to_host,
    info_dict,
    resolve_device,
)
from flashdeconv_tpu_torch.ops.bcd import (
    full_f32_matmul,
    objective_from_sums,
    objective_sums,
    run_prepared_solve,
    scalar,
)
from flashdeconv_tpu_torch.utils.timing import span


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

    def _other_cards(self):
        """``(shard, its card's current stream)`` for this process's shards
        on a card other than the main device."""
        return [(s, torch.cuda.current_stream(self.devices[s]))
                for s in self.local if self.devices[s] != self.main]

    def fork(self) -> None:
        """Every shard's streams wait for the work queued so far on the
        main device's current stream, and on their own card's (where the
        operands on a card other than the main device were made)."""
        if not self.cuda:
            return
        self._ensure_streams()
        event = torch.cuda.current_stream(self.main).record_event()
        for stream in (*self._streams, *self._side):
            stream.wait_event(event)
        for s, current in self._other_cards():
            self._streams[s].wait_stream(current)
            self._side[s].wait_stream(current)

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
        streams, and each other card's current stream for its shards' (so
        that what is queued there next, or reuses their memory, follows
        them)."""
        if self.cuda and self._streams is not None:
            main = torch.cuda.current_stream(self.main)
            for stream in (*self._streams, *self._side):
                main.wait_stream(stream)
            for s, current in self._other_cards():
                current.wait_stream(self._streams[s])
                current.wait_stream(self._side[s])

    def copy(self, t: torch.Tensor, src: Optional[int], dst: Optional[int],
             out: Optional[torch.Tensor] = None, side: bool = False):
        """``t`` moved to shard ``dst``'s card: copied into ``out`` (a
        tensor there) and returned, or returned as a new tensor there.

        ``src`` is the shard whose stream wrote ``t`` (None: the main
        device's current stream, or a host tensor), ``dst`` the shard whose
        stream reads the copy (its halo-copy stream with ``side``; None:
        the main device's current stream). Where ``t`` already lies on that
        card, or on the CPU, this is the plain copy (or none, for ``.to``)
        queued on dst's stream, as a mesh of one card has always run it.
        Between two cards the copy runs on the source card, on shard
        ``src``'s halo-copy stream (the main shard's with None), after what
        the source's stream has queued so far; dst's stream waits for it,
        and so does the source's stream, which thus cannot write ``t``
        again under the copy.
        """
        dst_dev = self.main if dst is None else self.devices[dst]
        target = (contextlib.nullcontext() if dst is None
                  else self.on(dst, side))
        src_dev = t.device if src is None else self.devices[src]
        if not self.cuda or src_dev.type != "cuda" or src_dev == dst_dev:
            with target:
                return t.to(dst_dev) if out is None else out.copy_(t)
        self._ensure_streams()
        writer = (torch.cuda.current_stream(src_dev) if src is None
                  else self._streams[src])
        copier = self._side[self.local[0] if src is None else src]
        copier.wait_stream(writer)
        # ATen copies between cards on the source card's current stream,
        # after the destination card's current stream, which then waits
        # for the copy.
        with target, torch.cuda.stream(copier):
            moved = t.to(dst_dev) if out is None else out.copy_(t)
        writer.wait_stream(copier)
        return moved

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
        """Join, then ``tensors`` (each written on the stream of this
        process's shard on its card) on the main device."""
        self.join()
        return [self.copy(t, self.shard_on(t.device), None)
                for t in tensors]

    def shard_on(self, device: torch.device) -> Optional[int]:
        """The first of this process's shards on ``device``, else None."""
        return next((s for s in self.local if self.devices[s] == device),
                    None)

    def gather_all(self, tensors: Sequence[Optional[torch.Tensor]]) -> list:
        """Join, then every shard's tensor on the main device: ``tensors``
        holds one per shard, None where another process owns it (on a mesh
        that spans processes; all of one shape and dtype there)."""
        if not self.spans_processes:
            return self.gather(tensors)
        self.join()
        return [self.copy(t, None, None) for t in self.exchange(tensors)]

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
            parts = self._all_gather(torch.stack(self.gather(local)))
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


def uniform_result(n_spots: int, n_types: int,
                   converged: Optional[bool] = None, **extra):
    """The degenerate / zero-iteration result of a mesh: the single-device
    one (``core.solver._degenerate_result``), ``converged`` overridden
    when given, and the mesh's ``extra`` keys."""
    beta, info = _degenerate_result(n_spots, n_types)
    if converged is not None:
        info["converged"] = converged
    return beta, {**info, **extra}


class MeshProblem:
    """The solve of a prepared problem of the halo plan or the banded mesh.

    A subclass holds ``mesh``, ``dtype``, ``n_spots``, ``n_types``,
    ``n_shards``, ``YtY``, ``rho_scale`` and the per-shard ``Xty_t``,
    ``XtX`` and ``nnb``, and gives its state (``_beta0``, ``_sweep_ops``;
    it may override :meth:`_state` and :meth:`_data`), its chunk of sweeps
    (``_iterate``, under ``ops.bcd.converge``), each shard's neighbour
    sums (``_neighbor_sums``) and its ``info`` keys (``_info_keys``).
    """

    def solve(
        self,
        lambda_: float = 0.1,
        rho: float = 0.01,
        max_iter: int = 100,
        tol: float = 1e-4,
        verbose: bool = False,
        beta_init: Optional[np.ndarray] = None,
        return_device: bool = False,
    ) -> Tuple[np.ndarray, dict]:
        """Run the sweeps; returns ``(beta (n_spots, K) float64, info)``,
        beta in the original spot order, or with ``return_device`` a
        contiguous (n_spots, K) tensor in the solve dtype on the mesh's
        main device, un-permuted there (not on a mesh that spans
        processes, where every process gets the host beta). The call is
        the span ``flashdeconv.solve``."""
        with span("flashdeconv.solve"):
            if return_device and self.mesh.spans_processes:
                raise ValueError(
                    "return_device=True is not available on a mesh whose "
                    "shards span processes: the device beta of the other "
                    "processes' shards lies in their memory (the JAX package "
                    "cannot fetch it from one process either); solve() "
                    "returns the whole beta on the host on every process")
            beta, info = self._solve(lambda_, rho, max_iter, tol, verbose,
                                     beta_init)
            # A zero-sweep solve returns its host beta as it is.
            if isinstance(beta, torch.Tensor):
                beta = (beta.contiguous() if return_device
                        else fetch_to_host(beta))
            return beta, info

    def _scalars(self, lambda_, rho):
        """``(lambda, rho * mean diag(XtX))`` in the solve dtype."""
        return (scalar(lambda_, self.dtype),
                scalar(rho * self.rho_scale, self.dtype))

    def _solve(self, lambda_, rho, max_iter, tol, verbose, beta_init):
        """The sweeps; beta on the main device (every shard's, on every
        process), or the zero-sweep host result."""
        if max_iter == 0:
            return uniform_result(self.n_spots, self.n_types,
                                  converged=False,
                                  **self._info_keys(solved=False))
        validate_beta_init(beta_init, self.n_spots, self.n_types)
        lam, rho_eff = self._scalars(lambda_, rho)
        state = self._state(self._beta0(beta_init))
        with full_f32_matmul():
            sweep_ops = self._sweep_ops(lam, rho_eff)

            def run_chunk(n):
                cur, spare, it, rel = self._iterate(state, lam, rho_eff, tol,
                                                    n, sweep_ops)
                state[:] = [cur, spare]
                return it, rel

            n_iter, rel, converged, objectives = run_prepared_solve(
                run_chunk,
                lambda: self._objective(self._data(state[0]), lam, rho_eff),
                max_iter, tol, verbose, self.dtype)
            beta_d = self._beta(self._data(state[0]))
        return beta_d, info_dict(n_iter, rel, converged, objectives, verbose,
                                 **self._info_keys(solved=True))

    def _state(self, betas) -> list:
        """The loop state of ``betas``: ``[current, spare]`` per-shard
        buffers."""
        return [betas, self.mesh.per_shard(
            lambda s: torch.empty_like(betas[s]))]

    def _data(self, current) -> list:
        """Each shard's (K, n_local) beta of the loop's current buffers."""
        return current

    def _beta(self, betas) -> torch.Tensor:
        """The shards' ``betas`` gathered on the main device, (n_spots,
        K)."""
        return torch.cat(self.mesh.gather_all(betas),
                         dim=1)[:, :self.n_spots].T

    def _objective(self, betas, lam, rho) -> torch.Tensor:
        """The objective: each shard's sums over its own columns, added on
        the main device in shard order (every process, on a mesh that spans
        processes)."""
        mesh = self.mesh
        shard_ns = self._neighbor_sums(betas)
        sums, btbs = [None] * len(mesh), [None] * len(mesh)
        for s in mesh.local:
            with mesh.on(s):
                sums[s], btbs[s] = objective_sums(
                    betas[s], self.Xty_t[s], shard_ns(s), self.nnb[s])
        sums, btbs = mesh.gather_all(sums), mesh.gather_all(btbs)
        return objective_from_sums(torch.stack(sums).sum(0),
                                   torch.stack(btbs).sum(0),
                                   self.XtX[mesh.local[0]], self.YtY, lam,
                                   rho)
