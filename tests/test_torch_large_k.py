"""The port at 64 < K <= 384 against the JAX package, on the CPU.

Above K = 64 both packages run the Gauss-Seidel pass in panels of 16
coordinates. The pass and the two sweep kernels' plain versions are held
against the JAX Pallas kernels in interpret mode in tests/test_torch_bcd.py
and tests/test_torch_gather.py (their K lists reach 256 and 128). Here:

- the coordinate-descent plain version at K = 160, where the JAX package
  runs its XLA ``coordinate_descent`` (the classic pass, which divides where
  the panel pass multiplies by a reciprocal; f32 sums differ across panels,
  so atol 5e-5 / rtol 1e-4, the bounds of the JAX package's
  ``test_panel_pass_matches_classic_pass``);
- whole solves at K = 96 on each of the port's three tiers (the fused one
  also with the rest stream) against the JAX solve on the CPU (its XLA
  tiers): the same sweeps and max |delta beta| <= 1e-4
  (``benchmarks/hw_parity.py`` check 5);
- a whole fit at K = 96 against the JAX fit;
- the wrappers' bounds (K = 256 and ``KERNEL_MAX_K`` = 384 are taken,
  ``KERNEL_MAX_K + 1`` raises; 257 did while the kernels stopped at 256),
  the one-block range's launch counters (``.wide_launches``), a solve at
  K = 256, and a fused-tier solve of a 9,216-spot grid at K = 338 (the
  Allen whole-mouse-brain subclasses) against the benchmark's plain
  reference in f64 (``portbench/reference/solve.py``) and the JAX
  package's XLA-tier solve in f32.
"""

import contextlib
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashdeconv_tpu
import flashdeconv_tpu_torch
from conftest import make_synthetic
from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph
from torch_problems import with_long_edges

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

torch.set_num_threads(2)

K_LARGE = 96


def test_cd_block_reference_matches_jax_xla_at_k160():
    K, n = 160, 512
    rng = np.random.RandomState(K)
    Xs = rng.randn(K, 2 * K + 8)
    XtX = (Xs @ Xs.T).astype(np.float32)
    beta, ns, xty = (np.abs(rng.randn(n, K)).astype(np.float32)
                     for _ in range(3))
    xty *= 5.0
    nnb = rng.randint(0, 9, size=n).astype(np.float32)
    lam, rho = 0.4, 0.2
    ref = jbcd.coordinate_descent(
        jnp.asarray(beta), jnp.asarray(xty), jnp.asarray(XtX),
        jnp.asarray(ns), jnp.asarray(nnb), jnp.float32(lam),
        jnp.float32(rho),
    )
    t = torch.from_numpy
    inv = tbcd.gs_inv_den(t(XtX), t(nnb), lam)
    out, d, a = tbcd.coordinate_descent_block_reference(
        t(beta.T.copy()), t(xty.T.copy()), t(XtX), t(ns.T.copy()), inv,
        lam, rho,
    )
    np.testing.assert_allclose(out.numpy().T, np.asarray(ref), atol=5e-5,
                               rtol=1e-4)
    assert (out >= 0).all()


def _solve_case(tier):
    """(Y_sketch, X_sketch, coords, A) at K = 96 for ``tier``."""
    if tier == "gather":
        Y, X, _ = make_problem(3000, K_LARGE, 128, seed=1)
        coords = np.random.RandomState(1).rand(3000, 2) * np.sqrt(3000)
        return Y, X, coords, build_knn_graph(coords, k=6)
    Y, X, coords = make_problem(96 * 96, K_LARGE, 128, seed=2)
    A = build_knn_graph(coords, k=6)
    if tier == "banded":  # a remainder over the fused tier's gate
        A = with_long_edges(A, n_edges=800)
    if tier == "fused_rest":  # a small remainder: the rest stream
        A = with_long_edges(A)
    return Y, X, coords, A


@pytest.mark.parametrize("tier", ["fused", "fused_rest", "banded", "gather"])
def test_large_k_solve_matches_jax_cpu(tier):
    Y, X, coords, A = _solve_case(tier)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert prob.use_fused_banded == tier.startswith("fused")
    assert prob.use_banded == (tier != "gather")
    assert (prob.use_fused_banded and prob.tier.rest_touched is not None
            ) == (tier == "fused_rest")
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4)
    beta, info = prob.solve(**kw)
    ref, rinfo = jsolver.prepare_bcd(Y, X, A, coords=coords).solve(**kw)
    assert info["converged"] and rinfo["converged"]
    assert info["n_iterations"] == rinfo["n_iterations"]
    assert np.abs(beta - ref).max() <= 1e-4
    np.testing.assert_allclose(info["final_objective"],
                               rinfo["final_objective"], rtol=1e-5)


def test_large_k_fit_matches_jax():
    """A 40 x 40 grid (the gather tier) at K = 96: the same genes, lambda
    and sweeps, proportions within 1e-4."""
    Y, X, coords, _ = make_synthetic(n_spots=1600, n_genes=1200,
                                     n_types=K_LARGE, seed=5,
                                     sparse_output=True)
    ref = flashdeconv_tpu.FlashDeconv()
    ref.fit(Y, X, coords)
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    props = port.fit_transform(Y, X, coords)
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    assert port.lambda_used_ == ref.lambda_used_
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    assert props.shape == (1600, K_LARGE)
    np.testing.assert_allclose(props, ref.proportions_, atol=1e-4)


@pytest.mark.parametrize("kernel", ["fused", "cd"])
def test_wrappers_take_k256_and_refuse_k257(kernel):
    """K = 256 and ``KERNEL_MAX_K`` run the plain version on a CPU tensor
    and launch nothing; ``KERNEL_MAX_K + 1`` raises before any launch (the
    case's name is from when the kernels stopped at 256)."""
    def call(K):
        z = torch.zeros((K, 64))
        xtx = torch.eye(K)
        if kernel == "cd":
            return tbcd.coordinate_descent_block(z, z, xtx, z, z, 0.1, 0.0)
        carry = torch.zeros((K, 64 + 2 * 32))
        masks = torch.ones((1, 64), dtype=torch.uint8)
        return tbcd.fused_banded_sweep(carry, z, xtx, masks, z, 0.1, 0.0,
                                       (1,), 1, 32)

    fn = (tbcd.coordinate_descent_block if kernel == "cd"
          else tbcd.fused_banded_sweep)
    before = (fn.launches, fn.large_k_launches, fn.wide_launches)
    for K in (256, tbcd.KERNEL_MAX_K):
        out, d, a = call(K)
        assert out.shape[0] == K and float(d) == 0.0 and float(a) == 0.0
    assert (fn.launches, fn.large_k_launches, fn.wide_launches) == before
    with pytest.raises(ValueError, match=f"K <= {tbcd.KERNEL_MAX_K}"):
        call(tbcd.KERNEL_MAX_K + 1)


def test_solver_takes_k256_on_the_cpu():
    """K = 256 prepares and solves (the gather tier, 500 spots; above
    ``KERNEL_MAX_K`` the XLA tier takes the solve,
    tests/test_torch_xla_tier.py)."""
    rng = np.random.RandomState(7)
    coords = rng.rand(500, 2) * 22.0
    A = build_knn_graph(coords, k=6)
    X = rng.randn(256, 300)
    Y = np.abs(rng.randn(500, 256)) @ X
    beta, info = tsolver.bcd_solve(Y, X, A, coords=coords, max_iter=3,
                                   device="cpu")
    assert beta.shape == (500, 256) and np.isfinite(beta).all()
    assert info["n_iterations"] == 3


# -- the Allen whole-mouse-brain subclasses (K = 338) -------------------------

ROOT = Path(__file__).resolve().parents[1]
K338 = json.loads((ROOT / "portbench" / "configs"
                   / "stereoseq_bin20_k338.json").read_text())


def test_k338_fused_tier_solve_matches_the_references():
    """The configuration ``stereoseq_bin20_k338`` on a 96 x 96 grid (9,216
    bins, past the fused tier's gate), made by ``portbench.inputs`` from
    its own file: ``prepare_bcd`` takes the fused tier in f32 (the tile
    pass's plain twin on the CPU); ``solve`` takes the sweeps of the
    benchmark's plain reference in f64 with beta within its ``beta_gap``
    limit (2e-5 of max|beta_ref|), and lies within 1e-4 of the JAX
    package's f32 solve (its XLA tier at K > 256), the same sweeps."""
    from portbench import inputs
    from portbench.reference import solve as ref_solve

    cfg = dict(K338, layout=dict(K338["layout"], side=96))
    coords = inputs.layout_coords(cfg["layout"])
    A = inputs.knn_graph(coords, int(cfg["k_neighbors"]))
    Y, X = (a.numpy() for a in inputs.sketch_problem(cfg, coords,
                                                     2**31 + 338, "cpu"))
    s = cfg["solve"]
    kw = dict(lambda_=s["lambda"], rho=s["rho"], tol=s["tol"],
              max_iter=s["max_iter"])
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, dtype=np.float32,
                               device="cpu")
    assert type(prob.tier).__name__ == "FusedBandedTier"
    assert prob.tier.uses_kernel and prob.n_types == 338
    beta, info = prob.solve(**kw)
    X64 = X.astype(np.float64)
    ref = ref_solve.bcd(ref_solve.xty_from_sketch(Y, X, "f64", "cpu"),
                        X64 @ X64.T, A, s["lambda"], s["rho"], s["tol"],
                        s["max_iter"], "f64")
    assert info["n_iterations"] == ref.n_iterations
    assert ref_solve.max_gap(torch.as_tensor(beta), ref.beta) <= 2e-5
    jbeta, jinfo = jsolver.prepare_bcd(Y, X, A, coords=coords,
                                       dtype=np.float32).solve(**kw)
    assert jinfo["n_iterations"] == info["n_iterations"]
    assert np.abs(beta - np.asarray(jbeta)).max() <= 1e-4


@pytest.mark.parametrize("K", [256, 257, 338, tbcd.KERNEL_MAX_K])
def test_wide_launches_count_the_one_block_range(K, monkeypatch):
    """The wrappers' launch path with the library stood in (a call that
    returns 0, no launch): each launch of either sweep kernel at K > 256
    counts on ``.wide_launches`` besides ``.large_k_launches``; at
    K = 256 it counts on ``.large_k_launches`` alone."""
    from flashdeconv_tpu_torch.ops import _build

    class Lib:
        def fdt_fused_banded_sweep_blocks(self, n_cols, K):
            return 1

        def fdt_cd_block_sweep_blocks(self, n, K):
            return 1

        def fdt_fused_banded_sweep(self, *args):
            return 0

        def fdt_cd_block_sweep(self, *args):
            return 0

    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "launch_stream",
                        lambda *ops: contextlib.nullcontext(0))
    z = torch.zeros((K, 64))
    carry = torch.zeros((K, 64 + 2 * 32))
    masks = torch.ones((1, 64), dtype=torch.uint8)
    rng = tbcd.sweep_range(carry.shape[1], 64, 1, 32, None, False)
    fused, cd = tbcd.fused_banded_sweep, tbcd.coordinate_descent_block
    names = ("launches", "large_k_launches", "wide_launches")
    before = [getattr(fn, a) for fn in (fused, cd) for a in names]
    tbcd._fused_banded_sweep_cuda(carry, z, torch.eye(K), masks, z, 0.1,
                                  0.0, (1,), 1, 32, torch.empty_like(carry),
                                  rng, None, None)
    tbcd._coordinate_descent_block_cuda(z, z, torch.eye(K), z, z, 0.1, 0.0,
                                        torch.empty_like(z))
    after = [getattr(fn, a) for fn in (fused, cd) for a in names]
    wide = int(K > tbcd.WIDE_ABOVE_K)
    assert [a - b for a, b in zip(after, before)] == [0, 1, wide] * 2
