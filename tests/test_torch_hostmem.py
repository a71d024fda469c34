"""The port's ``utils/hostmem.py``: the JAX package's arena cases
(tests/test_aux.py) and the repaired fault.

``mallopt`` changes the allocator of the whole process, so each case runs
in a child interpreter of its own: the test worker's allocator stays as it
was for the tests that run after these. The arenas are small (0.01-0.05
GB), as in the JAX tests. The repaired fault: a background fault pass that
raises commits no reserved size, its handle's ``wait()`` is False, and the
next reservation of that size faults again.
"""

import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def case_async_reservation():
    """The background reservation returns a waitable handle and the fault
    pass completes; a repeated call for the reserved size returns a
    completed handle at once."""
    from flashdeconv_tpu_torch.utils import hostmem

    h = hostmem.reserve_host_arena_async(0.05)
    assert h.wait(timeout=60) is True
    assert h.done and h.ok and h.error is None
    assert hostmem._reserved_bytes == int(0.05 * (1 << 30))
    h2 = hostmem.reserve_host_arena_async(0.05)
    assert h2.done and h2.wait() is True and h2._thread is None


def case_inflight_coalescing():
    """While a background fault is still running, a covered async
    re-request hands back the SAME handle, and the synchronous variant
    joins the flight before reporting success."""
    from flashdeconv_tpu_torch.utils import hostmem

    release, started = threading.Event(), threading.Event()
    real = hostmem._fault_and_release

    def gated(arena_box):
        started.set()
        release.wait(30)
        real(arena_box)

    hostmem._fault_and_release = gated
    try:
        h = hostmem.reserve_host_arena_async(0.01)
        assert h._thread is not None
        assert started.wait(10)
        assert not h.done and hostmem._reserved_bytes == 0
        h2 = hostmem.reserve_host_arena_async(0.01)
        assert h2 is h and not h2.done
        joined = {}
        t = threading.Thread(target=lambda: joined.setdefault(
            "ok", hostmem.reserve_host_arena(0.01)))
        t.start()
        t.join(0.3)
        assert t.is_alive(), "sync reserve returned before the flight ended"
        release.set()
        t.join(30)
        assert not t.is_alive() and joined.get("ok") is True
        assert h.wait(30) is True and h.done
        assert hostmem._reserved_bytes == int(0.01 * (1 << 30))
    finally:
        release.set()


def case_failed_fault_pass_commits_nothing():
    """``zero_fill`` raises in the background pass: ``wait()`` is False,
    the reserved size stays 0, and the next reservation tries again."""
    from flashdeconv_tpu_torch import native
    from flashdeconv_tpu_torch.utils import hostmem

    real = native.zero_fill

    def broken(arr):
        raise MemoryError("no pages for the arena")

    native.zero_fill = broken
    h = hostmem.reserve_host_arena_async(0.02)
    assert h.wait(timeout=60) is False
    assert h.done and not h.ok and isinstance(h.error, MemoryError)
    assert hostmem._reserved_bytes == 0
    native.zero_fill = real
    again = hostmem.reserve_host_arena_async(0.02)
    assert again is not h and again._thread is not None
    assert again.wait(timeout=60) is True and again.ok
    assert hostmem._reserved_bytes == int(0.02 * (1 << 30))


def case_sync_reservation():
    """The synchronous variant: a pass that raises propagates and records
    nothing; a pass that succeeds records the size, and a request it covers
    returns True without another pass."""
    from flashdeconv_tpu_torch import native
    from flashdeconv_tpu_torch.utils import hostmem

    real = native.zero_fill

    def broken(arr):
        raise MemoryError("no pages for the arena")

    native.zero_fill = broken
    try:
        hostmem.reserve_host_arena(0.01)
        raise AssertionError("the failed pass did not raise")
    except MemoryError:
        pass
    assert hostmem._reserved_bytes == 0
    native.zero_fill = real
    assert hostmem.reserve_host_arena(0.02) is True
    assert hostmem._reserved_bytes == int(0.02 * (1 << 30))
    native.zero_fill = broken
    assert hostmem.reserve_host_arena(0.01) is True  # covered: no pass


def case_without_glibc():
    """Where ``mallopt`` is not to be had, both variants report False and
    allocate nothing."""
    from flashdeconv_tpu_torch.utils import hostmem

    hostmem._enable_brk_retention = lambda: False
    assert hostmem.reserve_host_arena(0.01) is False
    h = hostmem.reserve_host_arena_async(0.01)
    assert h.done and h.wait() is False and not h.ok
    assert hostmem._reserved_bytes == 0


CASES = ["case_async_reservation", "case_inflight_coalescing",
         "case_failed_fault_pass_commits_nothing", "case_sync_reservation",
         "case_without_glibc"]


@pytest.mark.parametrize("case", CASES)
def test_hostmem_case_in_a_child(case):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-c", f"import test_torch_hostmem as t; t.{case}()"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
