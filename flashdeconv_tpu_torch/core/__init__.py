"""Pipeline and solver of the port: the names of :mod:`flashdeconv_tpu.core`,
each from the port's module of the same name."""

from flashdeconv_tpu_torch.core.deconv import FlashDeconv
from flashdeconv_tpu_torch.core.preprocess import preprocess_data
from flashdeconv_tpu_torch.core.sketching import (
    CountSketchOp,
    build_countsketch_matrix,
    build_sparse_rademacher_matrix,
    make_countsketch_op,
    project_to_sketch,
    sketch_data,
)
from flashdeconv_tpu_torch.core.solver import (
    BCDProblem,
    GraphDecomposition,
    bcd_solve,
    compute_objective,
    normalize_proportions,
    precompute_XtY,
    precompute_gram_matrix,
    prepare_bcd,
    soft_threshold,
)
from flashdeconv_tpu_torch.core.spatial import (
    auto_tune_lambda,
    compute_degree_matrix,
    compute_laplacian,
    compute_laplacian_quadratic,
    get_neighbor_counts,
    get_neighbor_indices,
)

__all__ = [
    "FlashDeconv",
    "preprocess_data",
    "CountSketchOp",
    "make_countsketch_op",
    "build_countsketch_matrix",
    "build_sparse_rademacher_matrix",
    "project_to_sketch",
    "sketch_data",
    "BCDProblem",
    "GraphDecomposition",
    "bcd_solve",
    "prepare_bcd",
    "compute_objective",
    "normalize_proportions",
    "precompute_XtY",
    "precompute_gram_matrix",
    "soft_threshold",
    "auto_tune_lambda",
    "compute_degree_matrix",
    "compute_laplacian",
    "compute_laplacian_quadratic",
    "get_neighbor_counts",
    "get_neighbor_indices",
]
