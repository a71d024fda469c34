"""Host-memory hygiene for atlas-scale pipelines.

The port's own copy of :mod:`flashdeconv_tpu.utils.hostmem`, with one
fault repaired: a background fault pass that fails leaves the reserved
size where it was and its handle reports the failure.

The O(nnz) host stages and the host copies of the results allocate
multi-GB arrays (gene subset, the normalized copy, the N x d sketch, the
(N, K) f64 beta that ``fetch_to_host`` fills). Fresh anonymous memory is
faulted in on its first touch, and on virtualized or overcommitted hosts
that can run at well under 100 MB/s from a single thread. Two answers:

* the native kernels fault their outputs from all worker threads
  (:func:`flashdeconv_tpu_torch.native.zero_fill`, per-block memsets);
* this module lets a pipeline pre-fault its heap ONCE so numpy's later
  allocations recycle already-faulted pages instead of paying the fault
  cost per stage.

:func:`reserve_host_arena` does that by (a) telling glibc to serve large
allocations from the persistent brk heap instead of transient mmaps
(``mallopt(M_MMAP_MAX, 0)``) and never to trim the heap back
(``M_TRIM_THRESHOLD``), then (b) allocating and parallel-faulting an arena
of the requested size and freeing it — the pages stay resident in the
allocator's free list for every later numpy temporary.

This changes process-global allocator behavior, so it is OPT-IN: a script
calls it at startup; the library never does.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import sys
import threading

import numpy as np

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_reserved_bytes = 0
_inflight = None  # ArenaReservation of a background fault still running
# Guards the check-then-act on the two globals above: two threads racing
# reserve_* could otherwise both see _inflight None and double-allocate
# arenas (peak RSS = 2 arenas + temporaries — the exact overcommit this
# module exists to prevent).
_lock = threading.Lock()


def _enable_brk_retention() -> bool:
    """mallopt the process so big allocations live on the persistent brk
    heap and are never trimmed back — the setup both reserve variants
    share. Returns False when glibc is unavailable."""
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt(ctypes.c_int(_M_MMAP_MAX), ctypes.c_int(0))
    mallopt(ctypes.c_int(_M_MMAP_THRESHOLD), ctypes.c_int(2**31 - 1))
    mallopt(ctypes.c_int(_M_TRIM_THRESHOLD), ctypes.c_int(2**31 - 1))
    return True


def _fault_and_release(arena_box: list) -> None:
    """Fault every page of the held arena, then drop it back to glibc."""
    from flashdeconv_tpu_torch import native

    arena = arena_box[0]
    if not native.zero_fill(arena):
        arena.fill(0)  # single-threaded fallback still pre-faults
    arena_box[0] = None  # pages stay in glibc's free list, already faulted


def reserve_host_arena(gigabytes: float) -> bool:
    """Pre-fault ``gigabytes`` of heap for reuse by later big allocations.

    Returns True on success; False when glibc's ``mallopt`` is unavailable
    (non-glibc platforms) — harmless, everything still works at the
    default fault cost. Idempotent for sizes already reserved. A fault
    pass that raises propagates, and the size is not recorded.
    """
    global _reserved_bytes, _inflight
    n = int(gigabytes * (1 << 30))
    with _lock:
        if _inflight is not None:
            # A background fault is (or was) running for some earlier
            # request: join it before trusting _reserved_bytes —
            # returning early while the faulting thread still holds its
            # arena would let the caller's multi-GB temporaries allocate
            # CONCURRENTLY with the held arena (no page recycling, peak
            # RSS = arena + temporaries). (The fault thread never takes
            # _lock, so waiting under it cannot deadlock; a concurrent
            # reserver blocking here is the intended serialization.)
            _inflight.wait()
            _inflight = None
        if n <= _reserved_bytes:
            return True
        if not _enable_brk_retention():
            return False
        _fault_and_release([np.empty(n, dtype=np.uint8)])
        _reserved_bytes = n
        return True


class ArenaReservation:
    """Handle for an in-flight background arena pre-fault.

    ``wait()`` blocks until the fault pass finishes and returns whether the
    reservation took effect: False on platforms without glibc ``mallopt``
    and when the fault pass failed. ``done`` is a non-blocking check.
    Stages that allocate multi-GB temporaries should ``wait()`` first so
    their allocations recycle the faulted pages; stages that only compute
    (graph build, device work, data generation already holding its memory)
    can run concurrently with the faulting.

    ``wait(timeout=...)`` returning False is AMBIGUOUS between "timed out
    — the background thread still holds the arena" and "reservation
    unavailable or failed". A caller about to allocate big temporaries on
    timeout must disambiguate with ``done``: if ``not done``, proceeding
    would allocate CONCURRENTLY with the held arena (peak RSS = arena +
    temporaries — the exact hazard this module exists to avoid); prefer
    waiting longer.
    """

    def __init__(self, thread, ok: bool, nbytes: int = 0):
        self._thread = thread
        self._ok = ok
        self.nbytes = nbytes
        self.error = None  # the exception of a fault pass that failed

    @property
    def done(self) -> bool:
        """Non-blocking: the fault pass is no longer running."""
        return self._thread is None or not self._thread.is_alive()

    @property
    def ok(self) -> bool:
        """The reservation is (or, while the pass runs, is expected to be)
        effective — False on platforms without glibc ``mallopt`` and after
        a fault pass that failed."""
        return self._ok

    def wait(self, timeout=None) -> bool:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
        return self._ok


def _background_fault(handle: ArenaReservation, arena_box: list) -> None:
    """The background thread's body: the fault pass, then its outcome. The
    reserved size is committed only after the pass succeeds; a pass that
    raises marks the handle failed and keeps the exception as
    ``handle.error``, so ``wait()`` returns False and the next reservation
    of that size tries again. (No lock is taken: the one writer of
    ``_reserved_bytes`` while a pass runs is this thread, and every reader
    joins it first.)"""
    global _reserved_bytes
    try:
        _fault_and_release(arena_box)
    except Exception as exc:  # the thread's boundary: reported on handle
        handle._ok = False
        handle.error = exc
        return
    finally:
        arena_box[0] = None  # release the arena on failure too
    _reserved_bytes = max(_reserved_bytes, handle.nbytes)


def reserve_host_arena_async(gigabytes: float) -> ArenaReservation:
    """Start the arena pre-fault on a background thread.

    The arena buffer is ALLOCATED on the calling thread (so glibc serves
    it from the main arena's brk heap — a worker-thread malloc would land
    in a per-thread arena whose pages later main-thread allocations never
    reuse); only the page-faulting pass runs in the background, so the
    caller can spend the fault time on work that allocates nothing big
    (building the spatial graph, preparing device operands).
    """
    global _inflight
    n = int(gigabytes * (1 << 30))
    with _lock:
        if _inflight is not None and not _inflight.done:
            if n <= _inflight.nbytes:
                # The running fault already covers this size: hand back
                # the SAME handle so wait()/done reflect the in-flight
                # pass (a fresh completed handle would let the caller
                # allocate while the faulting thread still holds the
                # arena).
                return _inflight
            _inflight.wait()  # need a bigger arena: finish the old first
        _inflight = None
        if n <= _reserved_bytes:
            return ArenaReservation(None, True, n)
        if not _enable_brk_retention():
            return ArenaReservation(None, False, n)
        arena_box = [np.empty(n, dtype=np.uint8)]  # caller-thread malloc
        handle = ArenaReservation(None, True, n)
        handle._thread = threading.Thread(
            target=_background_fault, args=(handle, arena_box),
            name="flashdeconv-arena", daemon=True,
        )
        handle._thread.start()
        _inflight = handle
        return handle
