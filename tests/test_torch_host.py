"""The port's copies of the host modules against their originals, bitwise.

``flashdeconv_tpu_torch`` keeps its own copies of the numpy/scipy/C++ host
modules of ``flashdeconv_tpu`` (the port imports nothing of the JAX
package). Each case below runs one function of a copy and of its original
on the same seeded inputs; the results must be equal bit for bit, arrays
in the same dtype, sparse matrices in the same structure.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
from scipy import sparse

import flashdeconv_tpu.core.deconv as j_preprocess
import flashdeconv_tpu.core.sketching as j_sketching
import flashdeconv_tpu.core.solver as j_solver
import flashdeconv_tpu.core.spatial as j_spatial
import flashdeconv_tpu.native as j_native
import flashdeconv_tpu.parallel.ordering as j_ordering
import flashdeconv_tpu.parallel.partition as j_partition
import flashdeconv_tpu.utils.genes as j_genes
import flashdeconv_tpu.utils.graph as j_graph
import flashdeconv_tpu.utils.metrics as j_metrics
import flashdeconv_tpu.utils.random as j_random
import flashdeconv_tpu.utils.timing as j_timing
import flashdeconv_tpu_torch.core.preprocess as t_preprocess
import flashdeconv_tpu_torch.core.sketching as t_sketching
import flashdeconv_tpu_torch.core.solver as t_solver
import flashdeconv_tpu_torch.core.spatial as t_spatial
import flashdeconv_tpu_torch.native as t_native
import flashdeconv_tpu_torch.parallel.ordering as t_ordering
import flashdeconv_tpu_torch.parallel.partition as t_partition
import flashdeconv_tpu_torch.utils.genes as t_genes
import flashdeconv_tpu_torch.utils.graph as t_graph
import flashdeconv_tpu_torch.utils.metrics as t_metrics
import flashdeconv_tpu_torch.utils.random as t_random
import flashdeconv_tpu_torch.utils.timing as t_timing
from conftest import make_synthetic

JAX_PKG = SimpleNamespace(
    preprocess=j_preprocess, sketching=j_sketching, solver=j_solver,
    spatial=j_spatial, native=j_native, genes=j_genes, graph=j_graph,
    metrics=j_metrics, random=j_random, timing=j_timing,
    ordering=j_ordering, partition=j_partition,
)
PORT = SimpleNamespace(
    preprocess=t_preprocess, sketching=t_sketching, solver=t_solver,
    spatial=t_spatial, native=t_native, genes=t_genes, graph=t_graph,
    metrics=t_metrics, random=t_random, timing=t_timing,
    ordering=t_ordering, partition=t_partition,
)

Y_CSR, X_SIG, COORDS, TRUTH = make_synthetic(
    n_spots=900, n_genes=500, n_types=6, seed=1, sparse_output=True
)
Y_DENSE = Y_CSR.toarray()
GENE_IDX = np.sort(np.random.RandomState(2).choice(500, 150, replace=False))
IRREGULAR = np.random.RandomState(3).rand(1200, 2) * 30
GRID = j_graph.grid_coords(side=96)
SCRAMBLE = np.random.RandomState(4).permutation(GRID.shape[0])
_LONG = np.random.RandomState(9).choice(GRID.shape[0] // 2, 12, replace=False)
# The grid graph plus 12 symmetric edges ~3,000-4,000 spots long: near-
# singleton bands that cap_sparse_bands spills.
GRID_LONG = (j_graph.build_knn_graph(GRID, k=6) + sparse.coo_matrix(
    (np.ones(24), (np.r_[_LONG, _LONG + 3000 + 80 * np.arange(12)],
                   np.r_[_LONG + 3000 + 80 * np.arange(12), _LONG])),
    shape=(GRID.shape[0],) * 2).tocsr() > 0).astype(np.float64)
SKETCH_Y = np.random.RandomState(5).randn(300, 64)
SKETCH_X = np.random.RandomState(6).randn(6, 64)
BETA = np.abs(np.random.RandomState(7).randn(300, 6))
BETA[[4, 9]] = 0.0


def _op(m):
    return m.sketching.make_countsketch_op(
        len(GENE_IDX), 64, leverage_scores=np.linspace(1, 2, len(GENE_IDX)),
        random_state=3,
    )


def _graph_plan(m, coords):
    A = m.graph.build_knn_graph(coords, k=6)
    g = m.solver.GraphDecomposition(A, coords.shape[0], coords=coords)
    return [getattr(g, k) for k in g.__slots__]


def _timer(m):
    timer = m.timing.StageTimer()
    timer.timings.update({"a": 1.5, "b": 0.25})
    return timer.report(), timer.total


CASES = {
    "genes_select_sparse": lambda m: m.genes.select_informative_genes(
        Y_CSR, X_SIG, n_hvg=200, n_markers_per_type=20),
    "genes_select_dense": lambda m: m.genes.select_informative_genes(
        Y_DENSE, X_SIG, n_hvg=200, n_markers_per_type=20),
    "genes_markers_ratio": lambda m: m.genes.select_markers(
        X_SIG, n_markers=10, method="ratio"),
    "graph_knn": lambda m: m.graph.build_knn_graph(IRREGULAR, k=6),
    "graph_radius": lambda m: m.graph.build_radius_graph(IRREGULAR, 1.5),
    "graph_grid": lambda m: m.graph.build_grid_graph(COORDS),
    "graph_dispatch": lambda m: m.graph.coords_to_adjacency(
        IRREGULAR, method="radius", radius=1.2),
    "graph_grid_coords": lambda m: m.graph.grid_coords(n_spots=1000),
    "graph_padded": lambda m: m.graph.adjacency_to_padded(
        m.graph.build_knn_graph(IRREGULAR, k=6)),
    "graph_padded_capped": lambda m: m.graph.adjacency_to_padded_capped(
        m.graph.build_radius_graph(IRREGULAR, 1.5), max_degree=5),
    "graph_banded_split": lambda m: m.graph.banded_split(
        m.graph.build_knn_graph(GRID, k=6), max_offsets=32,
        min_coverage=0.9),
    "graph_cap_sparse_bands": lambda m: m.graph.cap_sparse_bands(
        *m.graph.banded_split(m.graph.build_knn_graph(GRID, k=6),
                              max_offsets=32), 9216 * 6),
    "graph_cap_sparse_bands_long_edges": lambda m: m.graph.cap_sparse_bands(
        *m.graph.banded_split(GRID_LONG, max_offsets=32, min_coverage=0.9),
        GRID_LONG.nnz),
    "graph_cap_sparse_bands_over_spill": lambda m: m.graph.cap_sparse_bands(
        *m.graph.banded_split(GRID_LONG, max_offsets=32), 100),
    "sketch_op": lambda m: _op(m),
    "sketch_data_sparse": lambda m: m.sketching.sketch_data(
        Y_CSR, X_SIG, sketch_dim=64, random_state=0, backend="host"),
    "sketch_data_dense": lambda m: m.sketching.sketch_data(
        Y_DENSE, X_SIG, sketch_dim=64, random_state=0, backend="host"),
    "sketch_data_positional": lambda m: m.sketching.sketch_data(
        Y_CSR, X_SIG, 64, np.linspace(1, 2, 500), "countsketch", 4, "host"),
    "sketch_data_rademacher_sparse": lambda m: m.sketching.sketch_data(
        Y_CSR, X_SIG, 64, method="rademacher", random_state=0,
        backend="host"),
    "sketch_data_rademacher_dense": lambda m: m.sketching.sketch_data(
        Y_DENSE, X_SIG, 64, np.linspace(1, 2, 500), "rademacher", 5,
        "auto"),
    "sketch_op_to_dense": lambda m: (_op(m).to_dense(),
                                     _op(m).to_dense(np.float64)),
    "sketch_countsketch_matrix": lambda m:
        m.sketching.build_countsketch_matrix(
            500, 64, leverage_scores=np.linspace(1, 2, 500), random_state=6),
    "sketch_rademacher_matrix": lambda m:
        m.sketching.build_sparse_rademacher_matrix(
            500, 64, sparsity=0.2, leverage_scores=np.linspace(1, 2, 500),
            random_state=7),
    "native_fused_log1pcpm_xty": lambda m: m.native.fused_log1pcpm_xty(
        Y_CSR, GENE_IDX, _op(m).buckets, _op(m).weights, 64,
        SKETCH_X),
    "native_fused_colscale_xty": lambda m: m.native.fused_colscale_xty(
        Y_CSR, GENE_IDX, np.linspace(0.5, 2.0, len(GENE_IDX)),
        _op(m).buckets, _op(m).weights, 64, SKETCH_X),
    "native_subset_col_mean": lambda m: m.native.subset_col_mean(
        Y_CSR, GENE_IDX),
    "native_yty": lambda m: m.native.yty_f64(SKETCH_Y),
    "native_countsketch_project": lambda m: m.native.countsketch_project(
        Y_CSR[:, GENE_IDX].tocsr(), _op(m).buckets, _op(m).weights, 64),
    "native_moments_auto": lambda m: m.native.log1p_cpm_moments_auto(Y_CSR),
    "native_row_sums": lambda m: m.native.csr_row_sums(Y_CSR),
    "native_log1p_transform": lambda m: m.native.log1p_cpm_transform(
        Y_CSR, np.linspace(1.0, 3.0, Y_CSR.shape[0])),
    "spatial_auto_lambda": lambda m: m.spatial.auto_tune_lambda(
        SKETCH_Y, SKETCH_X, m.graph.build_knn_graph(IRREGULAR[:300], k=6)),
    "preprocess_log_cpm_sparse": lambda m: m.preprocess.preprocess_data(
        Y_CSR, X_SIG, "log_cpm"),
    "preprocess_log_cpm_dense": lambda m: m.preprocess.preprocess_data(
        Y_DENSE, X_SIG, "log_cpm"),
    "preprocess_pearson": lambda m: m.preprocess.preprocess_data(
        Y_CSR, X_SIG, "pearson"),
    "preprocess_raw": lambda m: m.preprocess.preprocess_data(
        Y_DENSE, X_SIG, "raw"),
    "preprocess_zero_poisoned_rows": lambda m:
        m.preprocess._zero_poisoned_csr_rows(
            sparse.csr_matrix(np.where(
                np.arange(Y_DENSE.size).reshape(Y_DENSE.shape) % 997 == 0,
                np.nan, Y_DENSE)), GENE_IDX, logcpm=True),
    "solver_graph_plan_grid": lambda m: _graph_plan(m, GRID),
    "solver_graph_plan_scrambled": lambda m: _graph_plan(m, GRID[SCRAMBLE]),
    "solver_graph_plan_irregular": lambda m: _graph_plan(m, IRREGULAR),
    "solver_gram": lambda m: m.solver.precompute_gram_matrix(SKETCH_X),
    "solver_sanitize_yty": lambda m: m.solver.sanitize_yty(
        None, np.where(np.arange(SKETCH_Y.size).reshape(SKETCH_Y.shape)
                       % 1001 == 0, np.nan, SKETCH_Y)),
    "solver_degenerate": lambda m: m.solver._degenerate_result(5, 3),
    "solver_normalize": lambda m: m.solver.normalize_proportions(BETA),
    "metrics_correlation": lambda m: (
        m.metrics.compute_correlation(BETA, BETA[::-1]),
        m.metrics.compute_correlation(BETA, BETA[::-1], "spearman", True)),
    "metrics_report": lambda m: m.metrics.evaluate_deconvolution(
        m.solver.normalize_proportions(BETA),
        m.solver.normalize_proportions(BETA[::-1])),
    "ordering_morton_codes": lambda m: m.ordering.morton_codes(IRREGULAR),
    "ordering_morton_3d": lambda m: m.ordering.morton_order(
        np.random.RandomState(8).rand(200, 3)),
    "ordering_spot_order": lambda m: (
        m.ordering.spot_order(GRID[SCRAMBLE], "morton"),
        m.ordering.spot_order(GRID[SCRAMBLE], "none")),
    "partition_plan_grid": lambda m: m.partition.plan_shards(
        m.graph.build_knn_graph(GRID[SCRAMBLE], k=6), 4,
        coords=GRID[SCRAMBLE]),
    "partition_plan_padded": lambda m: m.partition.plan_shards(
        m.graph.build_knn_graph(IRREGULAR, k=6), 3, coords=IRREGULAR,
        pad_deg_to=8, pad_shard_to=2048),
    "partition_halo_fraction": lambda m: m.partition.halo_fraction(
        m.partition.plan_shards(m.graph.build_knn_graph(IRREGULAR, k=6), 8,
                                coords=IRREGULAR)),
    "random_state": lambda m: m.random.check_random_state(11).rand(5),
    "timing_stage_timer": _timer,
}


def _assert_same(a, b, where="result"):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, type(a)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif sparse.issparse(a):
        assert sparse.issparse(b) and a.format == b.format, where
        a, b = a.tocsr(), b.tocsr()
        _assert_same((a.shape, a.indptr, a.indices, a.data),
                     (b.shape, b.indptr, b.indices, b.data), where)
    elif dataclasses.is_dataclass(a):
        _assert_same(dataclasses.asdict(a), dataclasses.asdict(b), where)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif a is None or isinstance(a, (str, bool)):
        assert a == b, where
    else:  # Python or numpy scalars
        assert type(a) is type(b), where
        np.testing.assert_array_equal(a, b, err_msg=where)


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_original(case):
    _assert_same(CASES[case](JAX_PKG), CASES[case](PORT))


def test_sanitize_yty_leaves_the_callers_sketch_unchanged():
    """The port's copy zeroes the poisoned rows in a copy: the caller's
    array is never written, even while the reduction runs."""
    Y = SKETCH_Y.copy()
    Y[[3, 77]] = np.nan
    before = Y.copy()
    yty = t_solver.sanitize_yty(None, Y)
    np.testing.assert_array_equal(Y, before)
    clean = np.where(np.isnan(Y), 0.0, Y)
    assert yty == t_native.yty_f64(clean) and np.isfinite(yty)


def test_chip_smoke_make_problem_matches_bench():
    """``chip_smoke.py`` keeps its own copy of ``bench.make_problem``: the
    same numbers from the same seed (the copy may not import bench)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench
    import chip_smoke

    for seed in (0, 3):
        _assert_same(bench.make_problem(5000, 7, 40, seed=seed),
                     chip_smoke.make_problem(5000, 7, 40, seed=seed))
