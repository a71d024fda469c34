"""Device layer of the port: plain PyTorch math and the CUDA kernels. The
names of :mod:`flashdeconv_tpu.ops`, plus the port's kernel wrappers."""

from flashdeconv_tpu_torch.ops.bcd import (
    bcd_iterate,
    bcd_iterate_banded,
    bcd_sweep,
    bcd_sweep_banded,
    coordinate_descent,
    coordinate_descent_block,
    converge_loop,
    fused_banded_sweep,
    neighbor_sum,
    neighbor_sum_banded,
    objective_terms,
    soft_threshold,
    sweep_stats,
)
from flashdeconv_tpu_torch.ops.countsketch import countsketch_project

__all__ = [
    "bcd_sweep",
    "bcd_iterate",
    "bcd_sweep_banded",
    "bcd_iterate_banded",
    "coordinate_descent",
    "coordinate_descent_block",
    "fused_banded_sweep",
    "neighbor_sum",
    "neighbor_sum_banded",
    "converge_loop",
    "sweep_stats",
    "objective_terms",
    "soft_threshold",
    "countsketch_project",
]
