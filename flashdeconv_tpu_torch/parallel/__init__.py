"""Spot-sharded solves over a mesh of torch devices.

Counterpart of :mod:`flashdeconv_tpu.parallel`: a :class:`Mesh` is an
ordered tuple of torch devices, one per shard (several shards may share a
card, or the CPU), whose shards may span the processes of a
``torch.distributed`` job (:mod:`~flashdeconv_tpu_torch.parallel.multihost`);
the halo plan (:mod:`~flashdeconv_tpu_torch.parallel.solver`) solves any
graph with the coordinate-descent kernel per shard, the banded mesh
(:mod:`~flashdeconv_tpu_torch.parallel.gspmd`) a wholly banded one with the
fused kernel and its sub-range form.
"""

from flashdeconv_tpu_torch.parallel import multihost
from flashdeconv_tpu_torch.parallel._runner import Mesh
from flashdeconv_tpu_torch.parallel.gspmd import (
    GspmdBandedProblem,
    gspmd_banded_solve,
)
from flashdeconv_tpu_torch.parallel.ordering import (
    morton_codes,
    morton_order,
    spot_order,
)
from flashdeconv_tpu_torch.parallel.partition import (
    ShardPlan,
    halo_fraction,
    plan_shards,
)
from flashdeconv_tpu_torch.parallel.solver import (
    HaloShardedProblem,
    ShardedBCDProblem,
    default_mesh,
    prepare_sharded_bcd,
    sharded_bcd_solve,
)

__all__ = [
    "GspmdBandedProblem",
    "HaloShardedProblem",
    "Mesh",
    "ShardedBCDProblem",
    "ShardPlan",
    "default_mesh",
    "gspmd_banded_solve",
    "halo_fraction",
    "morton_codes",
    "morton_order",
    "multihost",
    "plan_shards",
    "prepare_sharded_bcd",
    "sharded_bcd_solve",
    "spot_order",
]
