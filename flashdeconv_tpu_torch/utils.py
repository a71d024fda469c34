"""Host helpers the port shares with :mod:`flashdeconv_tpu` (numpy and
scipy, no JAX), re-exported so that a caller of the port's solver, which
needs an adjacency, imports one package."""

from flashdeconv_tpu.utils.graph import build_knn_graph, grid_coords
from flashdeconv_tpu.utils.metrics import compute_correlation

__all__ = ["build_knn_graph", "grid_coords", "compute_correlation"]
