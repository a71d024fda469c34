"""The program's own spans in a ``torch.profiler`` trace of the measured
window: one summary a span name (``flashdeconv.*``), from the raw events.

For each name, over the traced window:

- ``count``: the spans of that name;
- ``host_s``: the sum of their durations;
- ``self_s``: the same less the time that child program spans cover;
- ``device_s``: the device time of every kernel, copy and fill whose
  launching call (the host call of the CUDA API, ``cuda*`` or ``cu*``,
  that the activity's ``correlation_id`` names) lies inside a span of
  that name, its child spans included; clipped to the window, overlaps
  counted once;
- ``idle_s``: the time in the window that the device is idle while a span
  of that name is open on the window's thread (the device is idle where
  :mod:`portbench.tracing` finds no activity);
- ``launches``: the launching calls counted in ``device_s``.

A span counts where it lies on the thread that opened it; the program opens
its spans on the calling thread only, so a pool thread's work shows as the
caller's wait on it.

The harness's trace summary (:func:`portbench.tracing.reduce_profile`) does
not carry this one yet, so no metric reader sees it: a reader of a span's
device or idle time needs ``reduce_profile`` to add it under a key of its
own.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.tracing import WINDOW_SPAN

#: Prefix of the program's spans.
PROGRAM_PREFIX = "flashdeconv."
#: Kinds of event :func:`reduce_spans` reads.
WINDOW, SPAN, CALL, DEVICE = "window", "span", "call", "device"


def raw_events(prof):
    """``(name, kind, start_ns, end_ns, thread, correlation)`` of the
    window span, the program's spans, the CUDA API calls (host events
    named ``cu*``) and the device's activities (kernels, copies, fills;
    not the device-side copies of host spans)."""
    from torch.autograd import DeviceType

    cpu = DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("aten::"):  # most host events: skipped cheaply
            continue
        if e.device_type() != cpu:
            if e.is_user_annotation() or name.startswith(PROGRAM_PREFIX):
                continue
            kind = DEVICE
        elif name.startswith(PROGRAM_PREFIX):
            kind = SPAN
        elif name == WINDOW_SPAN:
            kind = WINDOW
        elif name.startswith("cu"):
            kind = CALL
        else:
            continue
        start = e.start_ns()
        out.append((name, kind, start, start + e.duration_ns(),
                    e.start_thread_id(), e.correlation_id()))
    return out


def _union(a: np.ndarray, b: np.ndarray):
    """The sorted, disjoint union of the intervals ``[a, b)``."""
    keep = b > a
    a, b = a[keep], b[keep]
    if not a.size:
        return a, b
    order = np.argsort(a, kind="stable")
    a, b = a[order], b[order]
    reach = np.maximum.accumulate(b)
    first = np.ones(a.size, dtype=bool)
    first[1:] = a[1:] > reach[:-1]
    heads = np.flatnonzero(first)
    return a[heads], np.maximum.reduceat(b, heads)


def _covered_upto(a: np.ndarray, b: np.ndarray, t: np.ndarray):
    """For disjoint sorted ``[a, b)``: the length they cover before each
    ``t``."""
    i = np.searchsorted(a, t, side="right")
    j = np.maximum(i - 1, 0)
    done = np.concatenate(([0], np.cumsum(b - a)))
    return np.where(i > 0, done[j] + np.clip(t - a[j], 0, b[j] - a[j]), 0)


def _overlap(a, b, c, d) -> int:
    """Length of the overlap of two disjoint sorted interval sets."""
    if not a.size or not c.size:
        return 0
    return int(np.sum(_covered_upto(a, b, d) - _covered_upto(a, b, c)))


def _inside(a, b, t) -> np.ndarray:
    """Whether each ``t`` lies in one of the disjoint sorted ``[a, b)``."""
    if not a.size:
        return np.zeros(t.size, dtype=bool)
    i = np.searchsorted(a, t, side="right") - 1
    return (i >= 0) & (t < b[np.maximum(i, 0)])


def _intervals(rows, w0, w1):
    """Start and end arrays of ``rows``' intervals, clipped to the
    window."""
    a = np.array([r[2] for r in rows], dtype=np.int64).reshape(-1)
    b = np.array([r[3] for r in rows], dtype=np.int64).reshape(-1)
    return np.clip(a, w0, w1), np.clip(b, w0, w1)


def reduce_spans(events) -> Dict[str, Dict]:
    """The summary above from :func:`raw_events`' tuples, or ``{}`` without
    a window span."""
    window = [e for e in events if e[1] == WINDOW]
    if not window:
        return {}
    _, _, w0, w1, wthread, _ = window[0]
    by_kind = {k: [] for k in (SPAN, CALL, DEVICE)}
    for e in events:
        if e[1] in by_kind:
            by_kind[e[1]].append(e)
    dev = by_kind[DEVICE]
    d0, d1 = _intervals(dev, w0, w1)
    d_corr = np.array([e[5] for e in dev], dtype=np.int64)
    busy_a, busy_b = _union(d0, d1)
    idle_a, idle_b = _union(np.concatenate(([w0], busy_b)),
                            np.concatenate((busy_a, [w1])))
    # The launching calls: host calls whose correlation an activity names.
    calls = by_kind[CALL]
    c_corr = np.array([e[5] for e in calls], dtype=np.int64)
    launching = np.isin(c_corr, d_corr)
    c_corr = c_corr[launching]
    c_t = np.array([e[2] for e in calls], dtype=np.int64)[launching]
    c_thread = np.array([e[4] for e in calls], dtype=np.int64)[launching]
    spans = [e for e in by_kind[SPAN] if e[3] > w0 and e[2] < w1]
    s_name = np.array([e[0] for e in spans], dtype=object)
    s0, s1 = _intervals(spans, w0, w1)
    s_thread = np.array([e[4] for e in spans], dtype=np.int64)
    out = {}
    for name in sorted(set(s_name)):
        mine = s_name == name
        host = int(np.sum(s1[mine] - s0[mine]))
        child, hit, idle = 0, [], 0
        for th in np.unique(s_thread[mine]):
            oa, ob = _union(s0[mine & (s_thread == th)],
                            s1[mine & (s_thread == th)])
            # Program spans of other names that open inside these.
            other = ~mine & (s_thread == th)
            kid = other.copy()
            kid[other] = _inside(oa, ob, s0[other])
            child += _overlap(oa, ob, *_union(s0[kid], s1[kid]))
            on = c_thread == th
            hit.append(c_corr[on][_inside(oa, ob, c_t[on])])
            if th == wthread:
                idle = _overlap(idle_a, idle_b, oa, ob)
        hit = np.unique(np.concatenate(hit))
        launched = np.isin(d_corr, hit)
        da, db = _union(d0[launched], d1[launched])
        out[name] = dict(count=int(mine.sum()), host_s=host * 1e-9,
                         self_s=(host - child) * 1e-9,
                         device_s=int(np.sum(db - da)) * 1e-9,
                         idle_s=idle * 1e-9, launches=int(hit.size))
    return out


def reduce_profile(prof) -> Dict[str, Dict]:
    return reduce_spans(raw_events(prof))

