"""The per-kernel roofline readers (``metrics/kernel_work.py``) on
synthetic traces, their work counted by hand, and the K = 34 cell by
name."""

from __future__ import annotations

import json

import pytest

from portbench import harness, inputs
from portbench.metrics import kernel_work, roofline
from portbench.tests.conftest import REPO

N, EDGES = 1_000_000, 6_968_962
PANEL = ("void fused_banded_sweep_panel_kernel<2, false>(float const*, "
         "long long, float*, long long)")
OBJECTIVE = ("void fused_banded_objective_kernel<40, false>(float const*, "
             "long long, float const*)")
OTHER = "void at::native::elementwise_kernel<128, 2>(int)"


def reader(name):
    return harness.load_module(REPO / "portbench" / "metrics"
                               / f"{name}.py")


def run(K, device_ops, solves=4, sweeps=6):
    return dict(records=[dict(sweeps=sweeps)] * solves,
                work=dict(n_spots=N, n_types=K, n_edges=EDGES),
                trace=dict(window_s=1.0, busy_s=0.5, device_ops=device_ops,
                           idle_gaps=[]))


@pytest.mark.parametrize("K,n_bytes,n_ops", [
    # carry and Xty 2 * 4 * K * n, degrees 4 * n, XtX 4 * K^2, one mask
    # byte a stored edge; (2K^2 + 9K + 1) a spot, K an edge.
    (20, 160e6 + 4e6 + 1600 + 6_968_962,
     1e6 * (800 + 180 + 1) + 20 * 6_968_962),
    (34, 272e6 + 4e6 + 4624 + 6_968_962,
     1e6 * (2312 + 306 + 1) + 34 * 6_968_962),
])
def test_objective_work_by_hand(K, n_bytes, n_ops):
    assert kernel_work.objective_bytes(N, K, EDGES) == pytest.approx(
        n_bytes, rel=1e-12)
    assert kernel_work.objective_ops(N, K, EDGES) == pytest.approx(
        n_ops, rel=1e-12)
    least, by = kernel_work.objective_bound_s(N, K, EDGES)
    assert by == "bytes"
    assert least == pytest.approx(n_bytes / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("K", [20, 34])
def test_readers_on_a_synthetic_trace(K):
    """Each share is its least time x its launches over its kernel's device
    seconds, whatever else the trace holds."""
    ops = [[PANEL, 0.03], [OTHER, 0.01], [OBJECTIVE, 0.002]]
    r = run(K, ops)
    sweep_least, _ = roofline.sweep_bound_s(N, K, EDGES)
    obj_least, _ = kernel_work.objective_bound_s(N, K, EDGES)
    assert reader("sweep.panel_roofline_pct").read(r) == pytest.approx(
        100.0 * sweep_least * 24 / 0.03)
    assert reader("solve.objective_roofline_pct").read(r) == pytest.approx(
        100.0 * obj_least * 4 / 0.002)


def test_the_sweep_at_k34_counted_by_hand():
    # carry in and out and Xty 3 * 4 * 34 * n, XtX 4 * 34^2, an int32 an
    # edge: 436 MB, 0.130 ms at 3.35 TB/s; ~3.94 GFLOP, 0.059 ms.
    n_bytes = 408e6 + 4624 + 4 * EDGES
    assert roofline.sweep_bytes(N, 34, EDGES) == pytest.approx(n_bytes)
    assert roofline.sweep_ops(N, 34, EDGES) == pytest.approx(
        1e6 * (2312 + 34 * 33 + 272) + 34 * EDGES)
    least, by = roofline.sweep_bound_s(N, 34, EDGES)
    assert by == "bytes" and least == pytest.approx(n_bytes / 3.35e12)


@pytest.mark.parametrize("name", ["sweep.panel_roofline_pct",
                                  "solve.objective_roofline_pct"])
def test_a_reader_without_its_kernel_reads_none(name):
    assert reader(name).read(run(34, [[OTHER, 0.01]])) is None
    assert reader(name).read(run(34, [])) is None
    assert reader(name).read(dict(run(34, []), trace=None)) is None
    assert reader(name).read(dict(run(34, [[PANEL, 0.03],
                                           [OBJECTIVE, 0.002]]),
                                  records=[])) is None


def test_the_k34_cell_resolves_by_name():
    cell = harness.Cell("stereoseq_bin20_k34.solve")
    assert cell.config["n_types"] == 34 and cell.config["reduced"] == []
    assert cell.config["tier"] == "FusedBandedTier"
    assert cell.limits == {"beta_gap": 2e-5, "sweeps_off": 0}
    assert {"solve_spots_per_s", "solve_ms_p95", "peak_device_gib",
            "setup_s"} == {m["name"] for m in cell.end_to_end}
    assert {"solve.sweeps", "sweep.roofline_pct", "device.idle_pct.solve",
            "sweep.panel_roofline_pct", "solve.objective_roofline_pct"} == {
        m["name"] for m in cell.per_layer}
    coords = inputs.layout_coords(cell.config["layout"])
    assert coords.shape == (cell.config["n_bins"], 2) == (1_000_000, 2)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    k20 = next(c for c in spec["configs"]
               if c["name"] == "stereoseq_bin20_k20")
    cfg20 = json.loads((REPO / k20["file"]).read_text())
    same = ("layout", "n_bins", "sketch_dim", "k_neighbors",
            "sketch_problem", "solve", "tier")
    assert all(cell.config[k] == cfg20[k] for k in same)
    assert cell.config["section_seed"] != cfg20["section_seed"]
