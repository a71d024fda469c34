"""Host helpers of the port (numpy and scipy): the spatial graph, gene
selection, metrics, random state and stage timing. Each module is the
port's own copy of its counterpart in :mod:`flashdeconv_tpu.utils`; the
names are those of :mod:`flashdeconv_tpu.utils`, with
:func:`as_torch_generator` in place of its JAX key bridge."""

from flashdeconv_tpu_torch.utils.genes import (
    compute_leverage_scores,
    select_hvg,
    select_informative_genes,
    select_markers,
)
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    banded_split,
    build_grid_graph,
    build_knn_graph,
    build_radius_graph,
    coords_to_adjacency,
    get_neighbor_counts,
    get_neighbor_indices,
    grid_coords,
)
from flashdeconv_tpu_torch.utils.metrics import (
    compute_correlation,
    compute_jsd,
    compute_mae,
    compute_rare_cell_detection,
    compute_rmse,
    evaluate_deconvolution,
)
from flashdeconv_tpu_torch.utils.random import (
    as_torch_generator,
    check_random_state,
)

__all__ = [
    "select_hvg",
    "select_markers",
    "compute_leverage_scores",
    "select_informative_genes",
    "build_knn_graph",
    "build_radius_graph",
    "build_grid_graph",
    "coords_to_adjacency",
    "adjacency_to_padded",
    "banded_split",
    "get_neighbor_counts",
    "get_neighbor_indices",
    "grid_coords",
    "compute_rmse",
    "compute_mae",
    "compute_correlation",
    "compute_jsd",
    "evaluate_deconvolution",
    "compute_rare_cell_detection",
    "check_random_state",
    "as_torch_generator",
]
