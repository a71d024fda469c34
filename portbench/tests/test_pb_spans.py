"""The reduction of the program's spans (:mod:`portbench.spans`) adds up
on synthetic kineto events, and the fit's stage readers read the
program's ``timings_``."""

from __future__ import annotations

import pytest

from portbench import harness, spans, tracing
from portbench.tests.conftest import REPO


class _Event:
    """A stand-in of a kineto event: (name, on the device, kind, start,
    end, thread, correlation); the kinds ``*user_annotation`` are
    spans."""

    def __init__(self, name, on_device, kind, a, b, thread, corr):
        from torch.autograd import DeviceType

        self._f = (name, DeviceType.CUDA if on_device else DeviceType.CPU,
                   kind, a, b - a, thread, corr)

    def name(self):
        return self._f[0]

    def device_type(self):
        return self._f[1]

    def is_user_annotation(self):
        return self._f[2] in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._f[3]

    def duration_ns(self):
        return self._f[4]

    def start_thread_id(self):
        return self._f[5]

    def correlation_id(self):
        return self._f[6]


class _Prof:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


#: A window [0, 1000) on thread 1: a solve [100, 700) holding two sweeps
#: and an objective; launches by correlation 11-16, a sync (17) that
#: launches nothing, a span on another thread, an aten op, and the
#: device-side copy of the solve span.
SPAN_EVENTS = [
    ("portbench.window", False, "user_annotation", 0, 1000, 1, 1),
    ("flashdeconv.solve", False, "user_annotation", 100, 700, 1, 2),
    ("flashdeconv.solve.sweep", False, "user_annotation", 150, 300, 1, 3),
    ("flashdeconv.solve.sweep", False, "user_annotation", 350, 450, 1, 4),
    ("flashdeconv.solve.objective", False, "user_annotation", 500, 650, 1,
     5),
    ("flashdeconv.other", False, "user_annotation", 100, 200, 2, 6),
    ("aten::mul", False, "cpu_op", 505, 530, 1, 13),
    ("cudaLaunchKernel", False, "cuda_runtime", 160, 170, 1, 11),
    ("cuLaunchKernel", False, "cuda_driver", 360, 370, 1, 12),
    ("cudaLaunchKernel", False, "cuda_runtime", 510, 515, 1, 13),
    ("cudaMemsetAsync", False, "cuda_runtime", 520, 525, 1, 14),
    ("cudaMemcpyAsync", False, "cuda_runtime", 680, 685, 1, 15),
    ("cudaStreamSynchronize", False, "cuda_runtime", 690, 698, 1, 17),
    ("cudaLaunchKernel", False, "cuda_runtime", 800, 805, 1, 16),
    ("k1", True, "kernel", 200, 320, 0, 11),
    ("k1", True, "kernel", 400, 480, 0, 12),
    ("obj", True, "kernel", 560, 600, 0, 13),
    ("fill", True, "gpu_memset", 590, 620, 0, 14),
    ("memcpy", True, "gpu_memcpy", 690, 720, 0, 15),
    ("k2", True, "kernel", 850, 1100, 0, 16),
    ("flashdeconv.solve", True, "gpu_user_annotation", 200, 720, 0, 2),
]


def test_span_reduction():
    prof = _Prof([_Event(*e) for e in SPAN_EVENTS])
    by = spans.reduce_profile(prof)
    ns = pytest.approx
    # Busy: [200,320) [400,480) [560,620) [690,720) [850,1000), as the
    # trace summary finds it (the device-side span copy is no activity).
    busy = 120 + 80 + 60 + 30 + 150
    summary = tracing.reduce_profile(prof)
    assert summary["busy_s"] == ns(busy * 1e-9)
    assert "spans" not in summary
    assert by["flashdeconv.solve.sweep"] == dict(
        count=2, host_s=ns(250e-9), self_s=ns(250e-9), device_s=ns(200e-9),
        idle_s=ns((50 + 50) * 1e-9), launches=2)
    # The fill overlaps the objective's kernel: counted once.
    assert by["flashdeconv.solve.objective"] == dict(
        count=1, host_s=ns(150e-9), self_s=ns(150e-9), device_s=ns(60e-9),
        idle_s=ns((60 + 30) * 1e-9), launches=2)
    # A kernel launched inside a child span counts to its parent too; the
    # sync launches nothing; the children's time is not the solve's own.
    assert by["flashdeconv.solve"] == dict(
        count=1, host_s=ns(600e-9), self_s=ns(200e-9),
        device_s=ns((120 + 80 + 60 + 30) * 1e-9),
        idle_s=ns((100 + 80 + 80 + 70) * 1e-9), launches=5)
    # Another thread's span: no idle time of the window's thread.
    assert by["flashdeconv.other"] == dict(
        count=1, host_s=ns(100e-9), self_s=ns(100e-9), device_s=0.0,
        idle_s=0.0, launches=0)
    assert set(by) == {"flashdeconv.solve", "flashdeconv.solve.sweep",
                       "flashdeconv.solve.objective", "flashdeconv.other"}
    # Without a window span there is nothing to reduce.
    assert spans.reduce_profile(_Prof([_Event(*SPAN_EVENTS[1])])) == {}


@pytest.mark.parametrize("name,stage", [
    ("fit.gene_selection_ms", "gene_selection"), ("fit.sketch_ms", "sketch")])
def test_fit_stage_readers_read_timings(name, stage):
    reader = harness.load_module(REPO / "portbench" / "metrics"
                                 / f"{name}.py")
    records = [dict(sweeps=12, timings={stage: s, "solve": 0.3})
               for s in (0.2, 0.25, 0.4)]
    assert reader.read(dict(records=records, trace=None)) == \
        pytest.approx(250.0)
    # A solve's records, or no record, hold no such stage.
    assert reader.read(dict(records=[dict(sweeps=5)], trace=None)) is None
    assert reader.read(dict(records=[], trace=None)) is None
