"""Per-stage wall-clock timing of the port's pipeline.

The port's own copy of :class:`flashdeconv_tpu.utils.timing.StageTimer`
(surfaced as ``FlashDeconv.timings_``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


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
