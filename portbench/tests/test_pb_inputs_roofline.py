"""The input makers repeat for a seed and change with it; the sweep's work
is counted as defined; the trace's reduction adds up."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import inputs, tracing
from portbench.metrics import roofline
from portbench.tests.conftest import REPO, tiny_config

CFG = {n: tiny_config(json.loads(
    (REPO / f"portbench/configs/{n}.json").read_text()))
    for n in ("stereoseq_bin20_k20", "vhd8um_tissue_k20")}


@pytest.mark.parametrize("name", sorted(CFG))
def test_sketch_problem_repeats_for_a_seed_and_changes_with_it(name):
    cfg = CFG[name]
    coords = inputs.layout_coords(cfg["layout"])
    big = 2**31 + 12345
    a = inputs.sketch_problem(cfg, coords, big, "cpu")
    b = inputs.sketch_problem(cfg, coords, big, "cpu")
    c = inputs.sketch_problem(cfg, coords, big + 1, "cpu")
    # The section (X, the truth) is the configuration's; the noise is the
    # run's.
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[1], c[1])
    assert torch.isfinite(a[0]).all()


def test_counts_and_signatures_repeat_for_a_seed_and_change_with_it():
    cfg = CFG["vhd8um_tissue_k20"]
    coords = inputs.layout_coords(cfg["layout"])
    X1, X2 = inputs.signatures(cfg), inputs.signatures(cfg)
    X3 = inputs.signatures(dict(cfg, section_seed=cfg["section_seed"] + 1))
    assert np.array_equal(X1, X2) and not np.array_equal(X1, X3)
    Y1, Y2, Y3 = (inputs.counts(cfg, coords, X1, s, "cpu")
                  for s in (3, 3, 4))
    assert (Y1 != Y2).nnz == 0 and (Y1 != Y3).nnz > 0
    assert Y1.shape == (cfg["n_bins"], cfg["n_genes"])
    assert Y1.data.dtype == np.float32 and Y1.indices.dtype == np.int32
    assert np.all(Y1.data > 0) and np.all(Y1.data == np.round(Y1.data))


def test_layouts_and_graph():
    grid = inputs.layout_coords(dict(kind="grid", side=5))
    assert grid.shape == (25, 2) and tuple(grid[7]) == (2.0, 1.0)
    full = json.loads(
        (REPO / "portbench/configs/vhd8um_tissue_k20.json").read_text())
    assert inputs.layout_coords(full["layout"]).shape[0] == full["n_bins"]
    A = inputs.knn_graph(grid, 4)
    assert (A != A.T).nnz == 0 and A.diagonal().sum() == 0
    assert set(np.unique(A.data)) == {1.0}
    assert np.diff(A.indptr).min() >= 4


def test_sweep_work_by_hand():
    # n = 10 spots, K = 3 types, 24 stored edges.
    n, K, E = 10, 3, 24
    assert roofline.sweep_bytes(n, K, E) == 4 * (3 * 3 * 10 + 9) + 4 * 24
    assert roofline.gs_ops(K, n) == 10 * (18 + 6 + 24)
    assert roofline.sweep_ops(n, K, E) == 480 + 3 * 24
    t, by = roofline.sweep_bound_s(n, K, E)
    assert by == "bytes" and t == pytest.approx(492 / 3.35e12)
    t, by = roofline.bound_s(1.0, 1e9)
    assert by == "operations" and t == pytest.approx(1e9 / 67e12)


def test_sweep_work_at_the_stereoseq_chip():
    # 1M spots, K = 20, ~7M edges: bound by bytes, ~0.08 ms.
    t, by = roofline.sweep_bound_s(1_000_000, 20, 7_000_000)
    assert by == "bytes"
    assert t == pytest.approx((4 * (60e6 + 400) + 28e6) / 3.35e12)


def test_trace_reduction():
    W = tracing.WINDOW_SPAN
    ev = [(W, False, 0, 1000, 1),
          ("portbench.solve", False, 0, 600, 1),
          ("aten::item", False, 100, 300, 1),
          ("k1", True, 120, 250, 0), ("k2", True, 200, 280, 0),
          ("memcpy", True, 500, 560, 0), ("k1", True, 990, 1100, 0),
          ("portbench.solve", True, 0, 600, 0),
          ("other thread", False, 0, 1000, 2)]
    s = tracing.reduce_events(ev)
    assert s["window_s"] == pytest.approx(1000e-9)
    assert s["busy_s"] == pytest.approx((160 + 60 + 10) * 1e-9)
    assert dict(s["device_ops"]) == pytest.approx(
        {"k1": 140e-9, "k2": 80e-9, "memcpy": 60e-9})
    gaps = dict(s["idle_gaps"])
    # [0,120): mid 60 in the solve span only; [280,500): mid 390;
    # [560,990): mid 775, outside any span.
    assert gaps["portbench.solve"] == pytest.approx((120 + 220) * 1e-9)
    assert gaps["host, outside any span"] == pytest.approx(430e-9)
    assert tracing.reduce_events([("x", True, 0, 5, 0)]) == {}
