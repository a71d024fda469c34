"""A NaN state against the JAX package: the sweep count of a solve whose
``beta_init`` holds a NaN.

The first sweep spreads the NaN to the spot's neighbours and makes the
stopping statistic NaN. The JAX one-program loops (``fused_solve_program``,
``solve_program``) stop there, after one sweep; the JAX chunked verbose
loop goes on chunk by chunk, each chunk one sweep, to ``max_iter``. The
port's solves are held to both: the same ``n_iterations``, ``converged``
and NaN pattern of beta, on the fused, the unfused banded and the gather
tier, and on the 2-shard banded mesh and halo plan, with and without
``verbose``. JAX runs its fused Pallas kernel in interpret mode (its
backend faked to "tpu" for the tier choice only, as
tests/test_torch_solver.py does), its XLA tiers otherwise.

The 2-shard solves are held against the JAX single-device solve of the same
problem: the JAX meshes reduce their statistics with ``lax.pmax``, which on
XLA:CPU drops a NaN (``pmax(nan, x) == x``, ``pmax(nan, nan) == -inf``), so
they sweep on and report ``converged`` with a NaN beta. The port's meshes
gather the statistics and take ``torch.amax``, which keeps the NaN, as the
single-device loops do.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu_torch import parallel as tpar
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.parallel import gspmd as tgspmd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords
from torch_problems import BLOCK, dropped_grid_coords

torch.set_num_threads(2)

KW = dict(lambda_=0.1, rho=0.01, max_iter=25, tol=1e-4)


def problem(coords, n_types=6, d=40, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n_types, d)
    Y = np.abs(rng.randn(coords.shape[0], n_types)) @ X \
        + 0.05 * rng.randn(coords.shape[0], d)
    init = np.full((coords.shape[0], n_types), 1.0 / n_types)
    init[5, 2] = np.nan
    return Y, X, build_knn_graph(coords, k=6), init


def assert_same_nan_state(port, ref, verbose):
    (tb, ti), (jb, ji) = port, ref
    assert ti["n_iterations"] == ji["n_iterations"]
    assert ti["n_iterations"] == (KW["max_iter"] if verbose else 1)
    assert ti["converged"] is False and ji["converged"] is False
    assert np.isnan(tb).any()
    np.testing.assert_array_equal(np.isnan(tb), np.isnan(jb))


def inputs(tier):
    coords = {"fused": grid_coords(side=96),
              "banded": dropped_grid_coords(100, 0.1),
              "gather": np.random.RandomState(1).rand(900, 2) * 30}[tier]
    return (coords, *problem(coords))


def jax_solve(tier, verbose):
    """The JAX solve of ``inputs(tier)``; its fused problem runs the Pallas
    kernel in interpret mode."""
    coords, Y, X, A, init = inputs(tier)
    backend = jax.default_backend
    if tier == "fused":
        jax.default_backend = lambda: "tpu"
    try:
        jp = jsolver.BCDProblem(Y, X, A, dtype=np.float32, coords=coords)
    finally:
        jax.default_backend = backend
    assert jp.use_fused_banded == (tier == "fused")
    assert jp.use_banded == (tier != "gather")
    with pltpu.force_tpu_interpret_mode():
        return jp.solve(verbose=verbose, beta_init=init, **KW)


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("tier", ["fused", "banded", "gather"])
def test_single_device_nan_state_matches_jax(tier, verbose):
    coords, Y, X, A, init = inputs(tier)
    tp = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert type(tp.tier).__name__ == {"fused": "FusedBandedTier",
                                      "banded": "BandedTier",
                                      "gather": "GatherTier"}[tier]
    ref = jax_solve(tier, verbose)
    got = tp.solve(verbose=verbose, beta_init=init, **KW)
    assert_same_nan_state(got, ref, verbose)
    assert len(got[1]["objectives"]) == len(ref[1]["objectives"])


@pytest.mark.parametrize("verbose", [False, True])
@pytest.mark.parametrize("strategy", ["banded", "halo"])
def test_two_shard_nan_state_matches_jax(strategy, verbose):
    """The fused banded mesh (blocks of 256) on the fused tier's grid and
    the halo plan on the gather tier's spots, each on 2 shards, against
    the JAX solve on that tier."""
    tier = "fused" if strategy == "banded" else "gather"
    coords, Y, X, A, init = inputs(tier)
    kw = dict(KW, verbose=verbose, beta_init=init)
    if strategy == "banded":
        tp = tgspmd.GspmdBandedProblem(Y, X, A, mesh=("cpu",) * 2,
                                       fused_block=BLOCK, device="cpu")
        assert tp.use_fused
        got = tp.solve(**kw)
    else:
        got = tpar.sharded_bcd_solve(Y, X, A, coords=coords,
                                     mesh=("cpu",) * 2, strategy="halo",
                                     device="cpu", **kw)
    assert got[1]["n_shards"] == 2
    assert_same_nan_state(got, jax_solve(tier, verbose), verbose)
