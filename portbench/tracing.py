"""Reduction of a ``torch.profiler`` trace of the measured window.

The harness opens the profiler (CPU and CUDA activities) around the window,
which it marks with a ``record_function`` span, and each timed call with a
span of its own. From the raw events this module takes:

- ``window_s``: the window span's length;
- ``busy_s``: the union of the device's activities (kernels, copies,
  fills) inside the window; the device-side copies of host spans (user
  annotations, such as the harness's own spans) are not activities;
- ``device_ops``: device seconds by activity name, the 10 largest;
- ``idle_gaps``: the device's idle time inside the window by what the host
  was doing when it began (the innermost host span open on the window's
  thread at the gap's middle), the 10 largest.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW_SPAN = "portbench.window"
#: Prefix of the harness's own spans.
SPAN_PREFIX = "portbench."
TOP = 10


def _raw_events(prof):
    """(name, is_device, start_ns, end_ns, thread) of every event but the
    device-side copies of host spans."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        on_device = e.device_type() != DeviceType.CPU
        if on_device and getattr(e, "is_user_annotation", bool)():
            continue
        start = int(e.start_ns())
        out.append((e.name(), on_device, start,
                    start + int(e.duration_ns()), e.start_thread_id()))
    return out


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted, disjoint union of ``intervals``."""
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def reduce_events(events) -> Dict:
    """The summary above from ``(name, is_device, start_ns, end_ns,
    thread)`` tuples, or ``{}`` without a window span."""
    window = [e for e in events if not e[1] and e[0] == WINDOW_SPAN]
    if not window:
        return {}
    _, _, w0, w1, thread = window[0]
    dev, by_name = [], defaultdict(int)
    for name, is_dev, a, b, _ in events:
        if not is_dev or name.startswith(SPAN_PREFIX):
            continue
        a, b = max(a, w0), min(b, w1)
        if b > a:
            dev.append((a, b))
            by_name[name] += b - a
    busy = merge(dev)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    host = sorted((a, -(b - a), b, name) for name, is_dev, a, b, th in events
                  if not is_dev and th == thread and name != WINDOW_SPAN)
    starts = [h[0] for h in host]
    idle = defaultdict(int)
    stack: List[Tuple[int, str]] = []
    j = 0
    for a, b in sorted(gaps):
        mid = (a + b) // 2
        hi = bisect.bisect_right(starts, mid)
        while j < hi:
            while stack and stack[-1][0] < host[j][0]:
                stack.pop()
            stack.append((host[j][2], host[j][3]))
            j += 1
        while stack and stack[-1][0] < mid:
            stack.pop()
        idle[stack[-1][1] if stack else "host, outside any span"] += b - a

    def top(d):
        return [[k, v * 1e-9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(window_s=(w1 - w0) * 1e-9,
                busy_s=sum(b - a for a, b in busy) * 1e-9,
                device_ops=top(by_name), idle_gaps=top(idle))


def reduce_profile(prof) -> Dict:
    return reduce_events(_raw_events(prof))


def idle_pct(summary) -> "float | None":
    """The share of the traced window in which no operation ran on the
    device, %, from :func:`reduce_events`' summary; None without one."""
    if not summary or not summary["window_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
