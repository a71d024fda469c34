"""Per-stage wall-clock timing, the sweep-timing protocol and profiler
traces of the port's pipeline.

The port's own copy of :mod:`flashdeconv_tpu.utils.timing`: a
:class:`StageTimer` collects wall-clock per pipeline stage into a plain dict
(surfaced as ``FlashDeconv.timings_``); :func:`fused_sweep_timer`,
:func:`fori_difference_windows` and :func:`fused_sweep_timer_for` time the
production fused banded sweep on the device; and :func:`trace` wraps a
block in a ``torch.profiler`` trace when a trace directory is configured —
a Chrome trace, viewable in Perfetto or ``chrome://tracing``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


class StageTimer:
    """Collects named wall-clock stage timings.

    Usage::

        timer = StageTimer()
        with timer.stage("sketch"):
            ...
        timer.timings  # {"sketch": 0.42, ...}
    """

    def __init__(self) -> None:
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = self.timings.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    @property
    def total(self) -> float:
        return sum(self.timings.values())

    def report(self) -> str:
        """Aligned multi-line report, slowest stage first."""
        if not self.timings:
            return "(no stages timed)"
        width = max(len(k) for k in self.timings)
        lines = [
            f"  {name:<{width}}  {secs:8.3f}s  ({100 * secs / max(self.total, 1e-12):5.1f}%)"
            for name, secs in sorted(
                self.timings.items(), key=lambda kv: -kv[1]
            )
        ]
        return "\n".join(lines + [f"  {'total':<{width}}  {self.total:8.3f}s"])


def fused_sweeps(carry, Xty_t, XtX, masks, inv_den_t, lam, rho, offsets,
                 h, block, n: int, rest_touched=None, rest_slots=None):
    """``n`` production fused banded sweeps from ``carry`` (left as it is);
    returns the carry after the last one.

    The sweeps are those of ``ops.bcd.bcd_iterate_banded_fused`` with
    ``tol=0``: they ping-pong between two carries, and with the rest tables
    (``rest_touched`` (T,), ``rest_slots`` (R, T) int64) a (K, n_solve)
    rest buffer, zero at the start, is refreshed from each sweep's input
    carry by ``rest_ns_update`` before the launch that reads it. Nothing
    is read back to the host. ``ops.bcd.fused_banded_sweep`` is looked up
    at each call, so a harness that swaps it times the swapped code. On
    CUDA tensors every sweep launches kernel #1 (or raises); on CPU tensors
    it runs the kernel's plain version.
    """
    from flashdeconv_tpu_torch.ops import bcd

    c, spare = carry.clone(), torch.empty_like(carry)
    ns_rest = None if rest_touched is None else Xty_t.new_zeros(Xty_t.shape)
    with bcd.full_f32_matmul():
        for _ in range(n):
            if ns_rest is not None:
                bcd.rest_ns_update(ns_rest, c, rest_touched, rest_slots)
            new, _diff, _abs = bcd.fused_banded_sweep(
                c, Xty_t, XtX, masks, inv_den_t, lam, rho, offsets, h,
                block, out=spare, ns_rest_t=ns_rest)
            c, spare = new, c
    return c


def fused_sweep_timer(carry, Xty_t, XtX, masks, inv_den_t, lam, rho,
                      offsets, h, block,
                      rest_touched=None, rest_slots=None):
    """Build ``timed(n) -> seconds`` for n PRODUCTION fused banded sweeps.

    The on-device measurement protocol: :func:`fused_sweeps` queues the n
    sweeps on the current stream with no host read between them (no
    statistic is fetched, nothing synchronises), as the solve queues them,
    rest-edge refresh included when the decomposition spilled any bands.
    The run ends with one scalar read of the carry, which waits for the
    stream, and only then is the host clock read. Time a short and a long
    run and divide the difference (:func:`fori_difference_windows`): it
    cancels what both runs pay once — filling the launch queue, the start
    carry's copy, the scalar read and any one-off allocation. ``lam`` and
    ``rho`` are the solve's f32 scalars (``rho`` already scaled by the mean
    of diag(XtX)), ``inv_den_t`` its ``gs_inv_den``.
    """

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        out = fused_sweeps(carry, Xty_t, XtX, masks, inv_den_t, lam, rho,
                           offsets, h, block, n, rest_touched=rest_touched,
                           rest_slots=rest_slots)
        float(out[0, 0])
        return time.perf_counter() - t0

    return timed


def fori_difference_windows(timed, n_short: int = 5, n_long: int = 30,
                            windows: int = 12) -> list:
    """Run the short/long difference protocol; per-sweep seconds.

    Warms both run lengths first, then alternates short and long timed
    runs, returning ``windows`` POSITIVE per-sweep differences ``(t_long -
    t_short) / (n_long - n_short)``. A stall landing on the short run makes
    a window non-positive; such windows are DISCARDED and resampled
    (clamping them to 0 would let ``min(windows)`` report a
    physically-impossible 0.0 as kernel truth), up to a 2x retry budget —
    if nothing positive survives even that, the device is stalled and this
    raises rather than fabricating a number. Report the min AND the
    median: if they disagree by >15% the device or the host is noisy —
    rerun. Check every reading against the streaming floor (bytes per
    sweep / HBM bandwidth) before trusting it.
    """
    timed(n_short)
    timed(n_long)
    out = []
    attempts = 0
    max_attempts = 2 * windows + 4
    while len(out) < windows and attempts < max_attempts:
        attempts += 1
        t_short = timed(n_short)
        t_long = timed(n_long)
        diff = (t_long - t_short) / (n_long - n_short)
        if diff > 0.0:
            out.append(diff)
    if not out:
        raise RuntimeError(
            f"all {attempts} timing windows were non-positive — the "
            "device is stalled; rerun the measurement"
        )
    return out


def fused_sweep_timer_for(problem, lambda_: float, rho: float):
    """:func:`fused_sweep_timer` wired from a prepared ``BCDProblem``.

    Builds the zero fused carry, the per-solve ``gs_inv_den`` stream and
    the scaled rho exactly as ``BCDProblem.solve`` does, so the timed
    loop is the production sweep of THAT problem, rest stream included.
    Requires ``problem.use_fused_banded``.
    """
    from flashdeconv_tpu_torch.ops.bcd import (
        gs_inv_den,
        scalar,
        to_fused_carry,
    )

    if not getattr(problem, "use_fused_banded", False):
        raise ValueError("problem does not run the fused banded kernel")
    tier = problem.tier
    lam = scalar(lambda_, tier.Xty_t.dtype)
    rho_eff = scalar(rho * problem.mean_diag, tier.Xty_t.dtype)
    carry = to_fused_carry(
        tier.Xty_t.new_zeros((problem.n_solve, problem.n_types)),
        tier.h, tier.block,
    )
    inv_den_t = gs_inv_den(tier.XtX, tier.nnb, lam)
    return fused_sweep_timer(
        carry, tier.Xty_t, tier.XtX, tier.masks, inv_den_t, lam, rho_eff,
        tier.offsets, tier.h, tier.block,
        rest_touched=tier.rest_touched, rest_slots=tier.rest_slot_cols,
    )


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None) -> Iterator[None]:
    """Wrap a block in a ``torch.profiler`` trace when tracing is enabled.

    Tracing is enabled by passing ``trace_dir`` or setting the
    ``FLASHDECONV_TRACE_DIR`` environment variable; otherwise this is a
    no-op that starts no profiler. When on, the profiler records the CPU and,
    where CUDA is available, the device's kernels and copies, and writes
    one Chrome trace (``*.pt.trace.json``) into the subdirectory ``name``
    of the trace directory, one subdirectory per ``name``.
    """
    trace_dir = trace_dir or os.environ.get("FLASHDECONV_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=(
            tensorboard_trace_handler(os.path.join(trace_dir, name)))):
        yield
