"""Host helpers of the port (numpy and scipy): the spatial graph, gene
selection, metrics, random state and stage timing. Each module is the
port's own copy of its counterpart in :mod:`flashdeconv_tpu.utils`."""

from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords
from flashdeconv_tpu_torch.utils.metrics import compute_correlation

__all__ = ["build_knn_graph", "grid_coords", "compute_correlation"]
