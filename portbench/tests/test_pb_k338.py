"""The configuration ``stereoseq_bin20_k338`` (the Allen whole-mouse-brain
subclasses, K = 338) in the benchmark: its cell resolves by name with the
k34 chip's settings but K and the section; its two per-layer readers,
split from ``solve.sweeps`` and ``sweep.panel_roofline_pct`` to move
``solve_ms_p95``, read what those read (the sweep at K = 338 counted by
hand), and nothing without a trace or without the panel kernel; and its
tiny stand-in (the 96 x 96 grid at K = 338, past the fused tier's
8,192-bin gate) takes the fused tier on the CPU.

The stand-in is registered in ``portbench/tests/conftest.py``'s ``TINY``
when this module is collected, before any fixture cuts the benchmark's
copy to size; every tiny-copy test of the directory then runs the new cell
too (``python -m pytest portbench/tests``)."""

from __future__ import annotations

import json

import pytest

from portbench import harness, inputs
from portbench.metrics import roofline
from portbench.tests import conftest as tests_conftest
from portbench.tests.conftest import REPO

tests_conftest.TINY.setdefault(
    "stereoseq_bin20_k338",
    dict(layout=dict(kind="grid", side=96), n_bins=96 * 96, n_types=338))

CELL = "stereoseq_bin20_k338.solve"
N, K, EDGES = 1_000_000, 338, 6_968_962
PANEL = ("void fused_banded_sweep_panel_kernel<11, false>(float const*, "
         "long long, float*, long long)")
OTHER = "Memcpy DtoH (Device -> Pageable)"


def reader(name):
    return harness.load_module(REPO / "portbench" / "metrics"
                               / f"{name}.py")


def test_the_k338_cell_resolves_by_name():
    cell = harness.Cell(CELL)
    assert cell.config["n_types"] == K and cell.config["reduced"] == []
    assert cell.config["sketch_dim"] > cell.config["n_types"]
    assert cell.config["tier"] == "FusedBandedTier"
    assert cell.limits == {"beta_gap": 2e-5, "sweeps_off": 0}
    assert {"solve_ms_p95", "peak_device_gib", "setup_s"} == {
        m["name"] for m in cell.end_to_end}
    assert {"solve.sweeps.p95", "sweep.panel_roofline_pct.p95"} == {
        m["name"] for m in cell.per_layer}
    assert all(m["moves"] == "solve_ms_p95" for m in cell.per_layer)
    coords = inputs.layout_coords(cell.config["layout"])
    assert coords.shape == (cell.config["n_bins"], 2) == (N, 2)
    k34 = json.loads((REPO / "portbench/configs/stereoseq_bin20_k34.json")
                     .read_text())
    same = ("layout", "n_bins", "sketch_dim", "k_neighbors",
            "sketch_problem", "solve", "tier")
    assert all(cell.config[k] == k34[k] for k in same)
    assert cell.config["section_seed"] != k34["section_seed"]


def test_the_sweep_at_k338_counted_by_hand():
    # carry in and out and Xty 3 * 4 * 338 * n, XtX 4 * 338^2, an int32 an
    # edge: 4.08 GB, 1.22 ms at 3.35 TB/s; 3.47e11 operations, 5.19 ms at
    # 67 TFLOP/s: bound by the operations.
    n_ops = 1e6 * (2 * K * K + K * (K - 1) + 8 * K) + K * EDGES
    assert roofline.sweep_bytes(N, K, EDGES) == pytest.approx(
        12 * K * 1e6 + 4 * K * K + 4 * EDGES)
    assert roofline.sweep_ops(N, K, EDGES) == pytest.approx(n_ops)
    least, by = roofline.sweep_bound_s(N, K, EDGES)
    assert by == "operations"
    assert least == pytest.approx(n_ops / 67e12) == pytest.approx(
        5.19e-3, rel=1e-3)


@pytest.mark.parametrize("name", ["solve.sweeps", "sweep.panel_roofline_pct"])
def test_the_split_readers_read_what_their_originals_read(name):
    """On a synthetic traced run (4 solves of 8 sweeps, the panel kernel's
    TM = 11 instance and a copy), the ``.p95`` reader equals its original;
    without a trace, or without the panel kernel, the roofline reads
    None."""
    run = dict(records=[dict(sweeps=8)] * 4,
               work=dict(n_spots=N, n_types=K, n_edges=EDGES),
               trace=dict(window_s=1.0, busy_s=0.5,
                          device_ops=[[PANEL, 0.9], [OTHER, 0.2]],
                          idle_gaps=[]))
    split, base = reader(f"{name}.p95"), reader(name)
    assert split.read(run) == base.read(run) is not None
    if name == "sweep.panel_roofline_pct":
        least, _ = roofline.sweep_bound_s(N, K, EDGES)
        assert split.read(run) == pytest.approx(100.0 * least * 32 / 0.9)
        assert split.read(dict(run, trace=None)) is None
        assert split.read(dict(run, trace=dict(
            run["trace"], device_ops=[[OTHER, 0.2]]))) is None
    else:
        assert split.read(run) == 8.0
        assert split.read(dict(run, records=[])) is None


def test_the_tiny_stand_in_takes_the_fused_tier(tiny_root):
    cell = harness.Cell(CELL, root=tiny_root)
    assert cell.config["n_bins"] == 96 * 96
    assert cell.config["n_types"] == K
    state = cell.loop.setup(cell.config, cell.traffic, 2**31 + 338, "cpu",
                            lambda msg: None)
    assert state["tier"] == "FusedBandedTier"
    assert state["program"].tier.uses_kernel
    rec = cell.loop.run_one(state)
    assert rec["spots"] == 96 * 96 and rec["sweeps"] >= 1
