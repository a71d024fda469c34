"""The port's XLA coordinate-descent tier against the JAX package's, on the
CPU.

Wherever the JAX package's Pallas kernels do not take a problem — f64 at
any K, and K > 128 off the TPU or K > 256 on it — it runs its XLA tier,
``coordinate_descent``; so does the port wherever its CUDA kernels do not
(f64, and K > 256). On the CPU the JAX solver runs that tier on every
problem (x64 on, as tests/conftest.py sets), so it is the reference here:

- one ``coordinate_descent`` sweep in f64 against the JAX one, within
  1e-13, at a K the JAX package unrolls and one it loops over;
- f64 solves on the three graph forms — a grid (the unfused banded form),
  a grid with long edges (banded with a rest table) and an irregular graph
  whose degree cap binds (the gather form with its overflow table) — cold,
  verbose and warm: the same sweeps and ``converged``, beta within rtol
  1e-10 / atol 1e-12, the objectives within rtol 1e-10;
- f32 solves at K = 257 and 300 on the same three graphs at 400 spots (the
  banded forms through a plan built past the 8,192-spot gate): the same
  sweeps, beta within 1e-5 of max|beta| (``benchmarks/hw_parity.py``'s
  bound for the XLA tier);
- the halo plan and the banded mesh on two CPU shards against the
  single-device solve: f64 within 1e-12, f32 at K = 257 within 1e-5, the
  same sweeps;
- ``FlashDeconv(solver_dtype=np.float64)`` against the JAX f64 fit within
  1e-10, its device outputs (f64 on the device, the fetch, ``fetch_dtype``,
  ``save`` / ``load``), the device argmax of a K = 257 fit fetched as
  int32, and ``tl.deconvolve`` with a 257-type reference against JAX's;
- the problems that raised before this tier was ported (f64, and K = 257
  on each tier), now solved against JAX, under their old case names.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashdeconv_tpu
import flashdeconv_tpu_torch
from conftest import make_synthetic
from fake_anndata import make_reference_adata, make_spatial_adata
from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu_torch.core import deconv as tdeconv
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.parallel import (
    gspmd_banded_solve,
    sharded_bcd_solve,
)
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords
from torch_problems import with_long_edges

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

torch.set_num_threads(2)

GRAPHS = ("grid", "grid_long_edges", "irregular_capped")
SOLVE = dict(lambda_=0.1, rho=0.01, max_iter=200, tol=1e-5)
F64 = dict(rtol=1e-10, atol=1e-12)


def _problem(graph: str, n_spots: int, n_types: int, d: int, seed=0):
    """``(Y_sketch, X_sketch, A, kw, plans)`` of one seeded problem on
    ``graph``: ``kw`` the solve keywords both packages take, ``plans``
    the JAX and the port's graph plan (None: each builds its own). A
    grid under the 8,192-spot gate gets a banded plan built past it."""
    Y, X, coords = make_problem(n_spots, n_types, d, seed=seed)
    if graph == "irregular_capped":
        coords = np.random.RandomState(seed).rand(n_spots, 2) * np.sqrt(
            n_spots)
    A = build_knn_graph(coords, k=6)
    if graph == "grid_long_edges":
        A = with_long_edges(A, n_edges=max(n_spots // 40, 4))
    kw = dict(coords=coords)
    if graph == "irregular_capped":
        kw["max_degree"] = 4
    plans = (None, None)
    if graph != "irregular_capped" and n_spots < 8192:
        plans = (jsolver.GraphDecomposition(A, 8192, coords),
                 tsolver.GraphDecomposition(A, 8192, coords))
    return Y, X, A, kw, plans


def _prepare_both(Y, X, A, kw, plans, dtype):
    jprob = jsolver.prepare_bcd(Y, X, A, dtype=dtype, graph_plan=plans[0],
                                **kw)
    tprob = tsolver.prepare_bcd(Y, X, A, dtype=dtype, graph_plan=plans[1],
                                device="cpu", **kw)
    return jprob, tprob


def _tier_name(graph: str) -> str:
    return "GatherTier" if graph == "irregular_capped" else "BandedTier"


def _check_xla_tier(tprob, graph: str, dtype) -> None:
    """The port took the XLA tier's form of ``graph``, in ``dtype``."""
    t = tprob.tier
    assert type(t).__name__ == _tier_name(graph)
    assert not t.uses_kernel
    assert t.Xty_t.dtype == t.XtX.dtype == t.nnb.dtype == (
        torch.float64 if dtype == np.float64 else torch.float32)
    if graph == "grid_long_edges":
        assert t.rest.shape[0] > 0
    if graph == "irregular_capped":
        assert t.overflow is not None


@pytest.mark.parametrize("K", [8, 96])
def test_coordinate_descent_sweep_matches_jax_f64(K):
    """One pass of both packages on the same f64 operands (JAX unrolls its
    loop at K <= 64 and runs a ``fori_loop`` above; both are one rule)."""
    n = 700
    rng = np.random.RandomState(K)
    Xs = rng.randn(K, 2 * K + 8)
    XtX = Xs @ Xs.T
    beta, ns, xty = (np.abs(rng.randn(n, K)) for _ in range(3))
    xty *= 5.0
    nnb = rng.randint(0, 9, size=n).astype(np.float64)
    nnb[:7] = 0.0
    lam, rho = 0.4, 0.2
    ref = np.asarray(jbcd.coordinate_descent(
        jnp.asarray(beta), jnp.asarray(xty), jnp.asarray(XtX),
        jnp.asarray(ns), jnp.asarray(nnb), lam, rho))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = torch.empty((K, n), dtype=torch.float64)
    got = tbcd.coordinate_descent(t(beta.T), t(xty.T), t(XtX), t(ns.T),
                                  t(nnb), lam, rho, out=out)
    assert got.data_ptr() == out.data_ptr()
    np.testing.assert_allclose(got.numpy().T, ref, rtol=0, atol=1e-13)


@pytest.mark.parametrize("mode", ["cold", "verbose", "warm"])
@pytest.mark.parametrize("graph", GRAPHS)
def test_f64_solve_matches_jax(graph, mode, capsys):
    Y, X, A, kw, plans = _problem(graph, 96 * 96, 8, 64)
    jprob, tprob = _prepare_both(Y, X, A, kw, plans, np.float64)
    _check_xla_tier(tprob, graph, np.float64)
    skw = dict(SOLVE, tol=1e-6, verbose=mode == "verbose")
    if mode == "warm":
        rng = np.random.RandomState(5)
        skw["beta_init"] = np.abs(rng.randn(*Y.shape[:1], X.shape[0])) * 0.2
    ref, rinfo = jprob.solve(**skw)
    beta, info = tprob.solve(**skw)
    assert info["n_iterations"] == rinfo["n_iterations"] < skw["max_iter"]
    assert info["converged"] == rinfo["converged"]
    np.testing.assert_allclose(beta, ref, **F64)
    np.testing.assert_allclose(info["final_objective"],
                               rinfo["final_objective"], rtol=1e-10)
    np.testing.assert_allclose(info["objectives"], rinfo["objectives"],
                               rtol=1e-10)
    if mode == "verbose":
        assert len(info["objectives"]) > 1
        assert "Converged at iteration" in capsys.readouterr().out


@pytest.mark.parametrize("K", [257, 300])
@pytest.mark.parametrize("graph", GRAPHS)
def test_f32_large_k_solve_matches_jax(graph, K):
    Y, X, A, kw, plans = _problem(graph, 400, K, K + 64)
    jprob, tprob = _prepare_both(Y, X, A, kw, plans, np.float32)
    _check_xla_tier(tprob, graph, np.float32)
    ref, rinfo = jprob.solve(**SOLVE)
    beta, info = tprob.solve(**SOLVE)
    assert info["n_iterations"] == rinfo["n_iterations"]
    assert info["converged"] and rinfo["converged"]
    assert np.abs(beta - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("strategy", ["halo", "banded"])
@pytest.mark.parametrize("dtype,K,bound", [(np.float64, 8, 1e-12),
                                           (np.float32, 257, 1e-5)])
def test_sharded_solves_match_the_single_device_solve(strategy, dtype, K,
                                                      bound):
    n = 1600 if dtype == np.float64 else 400
    Y, X, coords = make_problem(n, K, K + 64)
    A = build_knn_graph(coords, k=6)
    kw = dict(SOLVE, dtype=dtype)
    ref, rinfo = tsolver.bcd_solve(Y, X, A, coords=coords, device="cpu",
                                   **kw)
    if strategy == "halo":
        beta, info = sharded_bcd_solve(Y, X, A, coords=coords,
                                       mesh=("cpu",) * 2, strategy="halo",
                                       device="cpu", **kw)
    else:
        beta, info = gspmd_banded_solve(Y, X, A, mesh=("cpu",) * 2,
                                        device="cpu", **kw)
        assert info["fused_kernel"] is False
    assert info["n_shards"] == 2
    assert info["n_iterations"] == rinfo["n_iterations"] < kw["max_iter"]
    assert np.abs(beta - ref).max() <= bound * np.abs(ref).max()


def _fit_data(n_types: int):
    Y, X, coords, _ = make_synthetic(n_spots=300, n_genes=400,
                                     n_types=n_types, seed=3)
    return Y, X, coords


FIT = dict(sketch_dim=64, n_hvg=300, n_markers_per_type=10,
           max_iter=200, tol=1e-6)


def test_f64_fit_matches_jax():
    Y, X, coords = _fit_data(6)
    ref = flashdeconv_tpu.FlashDeconv(solver_dtype=np.float64, **FIT)
    ref.fit(Y, X, coords)
    model = flashdeconv_tpu_torch.FlashDeconv(solver_dtype=np.float64,
                                              device="cpu", **FIT)
    props = model.fit_transform(Y, X, coords)
    assert model.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(model.beta_, ref.beta_, **F64)
    np.testing.assert_allclose(props, ref.proportions_, rtol=1e-10,
                               atol=1e-10)


def test_f64_device_outputs_fetch_and_save(tmp_path):
    """An f64 fit's device outputs stay f64 on the device: beta and the
    proportions fetched lazily equal the host path's to f64 rounding,
    ``fetch_dtype="float32"`` rounds the proportions once, and ``save`` /
    ``load`` keep the f64 beta bit for bit."""
    Y, X, coords = _fit_data(6)
    kw = dict(FIT, solver_dtype=np.float64, device="cpu")
    host = flashdeconv_tpu_torch.FlashDeconv(device_outputs=False, **kw)
    host.fit(Y, X, coords)
    dev = flashdeconv_tpu_torch.FlashDeconv(device_outputs=True, **kw)
    dev.fit(Y, X, coords)
    assert dev._beta_dev.dtype == torch.float64
    np.testing.assert_array_equal(dev.beta_, host.beta_)
    np.testing.assert_allclose(dev.proportions_, host.proportions_,
                               rtol=0, atol=1e-15)
    f32 = flashdeconv_tpu_torch.FlashDeconv(device_outputs=True,
                                            fetch_dtype="float32", **kw)
    props = f32.fit_transform(Y, X, coords)
    np.testing.assert_array_equal(
        props, dev.proportions_.astype(np.float32).astype(np.float64))
    dev.save(tmp_path / "fit.npz")
    back = flashdeconv_tpu_torch.FlashDeconv.load(tmp_path / "fit.npz",
                                                  device="cpu")
    assert back.beta_.dtype == np.float64
    np.testing.assert_array_equal(back.beta_, dev.beta_)


def test_large_k_dominant_is_fetched_as_int32(monkeypatch):
    """Above K = 256 the device argmax does not fit a byte: it is cast to
    int32 on the device (uint8 at K <= 256), and agrees with the host
    argmax of the proportions."""
    rng = np.random.RandomState(11)
    K, n, g = 257, 300, 600
    X = rng.gamma(2.0, 1.0, size=(K, g))
    Y = rng.poisson(rng.dirichlet(np.ones(K), size=n) @ X * 20).astype(float)
    coords = rng.rand(n, 2) * 20
    wire = []
    real = tdeconv.fetch_to_host

    def spy(t, *a, **k):
        wire.append(t.dtype)
        return real(t, *a, **k)

    monkeypatch.setattr(tdeconv, "fetch_to_host", spy)
    model = flashdeconv_tpu_torch.FlashDeconv(
        device="cpu", device_outputs=True,
        outputs=("proportions", "dominant"), sketch_dim=512, n_hvg=500,
        n_markers_per_type=2, max_iter=5)
    model.fit(Y, X, coords)
    assert torch.int32 in wire and torch.uint8 not in wire
    np.testing.assert_array_equal(model.dominant_,
                                  np.argmax(model.proportions_, axis=1))


def test_deconvolve_at_k257_matches_jax():
    """``tl.deconvolve`` with a 257-type reference (fake AnnData) takes the
    XLA tier in both packages: the same parameters and sweeps, proportions
    within 1e-5."""
    Y, X, coords, _ = make_synthetic(n_spots=300, n_genes=1200, n_types=257,
                                     seed=4)
    genes = [f"g{i}" for i in range(Y.shape[1])]
    rng = np.random.RandomState(5)
    cells = np.vstack([rng.poisson(X[k] / (X[k].sum() + 1e-12) * 1500,
                                   size=(2, X.shape[1]))
                       for k in range(X.shape[0])]).astype(float)
    labels = np.repeat([f"t{k:03d}" for k in range(X.shape[0])], 2)
    out = []
    for pkg, kw in ((flashdeconv_tpu, {}),
                    (flashdeconv_tpu_torch, {"device": "cpu"})):
        st = make_spatial_adata(Y, coords, gene_names=genes)
        ref = make_reference_adata(cells, labels, gene_names=genes)
        pkg.tl.deconvolve(st, ref, sketch_dim=512, n_hvg=800,
                          n_markers_per_type=2, max_iter=30, **kw)
        out.append(st)
    ref_st, st = out
    assert st.uns["flashdeconv_params"] == ref_st.uns["flashdeconv_params"]
    P = st.obsm["flashdeconv"].to_numpy()
    assert P.shape == (300, 257)
    np.testing.assert_allclose(P, ref_st.obsm["flashdeconv"].to_numpy(),
                               atol=1e-5)


# The problems that raised NotImplementedError before this tier was ported
# (f64, and K = 257 on each of the three tiers: a grid the fused tier takes
# at f32 with K <= 256, a grid whose remainder takes the unfused banded
# tier, irregular coordinates) and the f64 constructor value: each now
# solves, against JAX.
@pytest.mark.parametrize("case", [
    "float64", "large_k_fused", "large_k_banded", "large_k_gather",
])
def test_once_unported_tiers_solve(case):
    rng = np.random.RandomState(3)
    side = 96 if case == "float64" else 20
    n, K, dtype = side * side, 257, np.float32
    coords = grid_coords(side=side)
    if case == "float64":
        K, dtype = 8, np.float64
    if case == "large_k_gather":
        coords = rng.rand(n, 2) * side
    A = build_knn_graph(coords, k=6)
    if case == "large_k_banded":
        A = with_long_edges(A, n_edges=40)
    X = rng.randn(K, K + 64)
    Y = rng.dirichlet(np.ones(K), size=n) @ X + 0.05 * rng.randn(n, K + 64)
    plans = (None, None)
    if case in ("large_k_fused", "large_k_banded"):
        plans = (jsolver.GraphDecomposition(A, 8192, coords),
                 tsolver.GraphDecomposition(A, 8192, coords))
    jprob, tprob = _prepare_both(Y, X, A, dict(coords=coords), plans, dtype)
    assert type(tprob.tier).__name__ == (
        "GatherTier" if case == "large_k_gather" else "BandedTier")
    assert not tprob.tier.uses_kernel
    ref, rinfo = jprob.solve(**SOLVE)
    beta, info = tprob.solve(**SOLVE)
    assert info["n_iterations"] == rinfo["n_iterations"]
    bound = 1e-12 if dtype == np.float64 else 1e-5
    assert np.abs(beta - ref).max() <= bound * np.abs(ref).max()


@pytest.mark.parametrize("kw", [{"solver_dtype": np.float64}])
def test_once_unported_constructor_values_fit(kw):
    Y, X, coords = _fit_data(5)
    ref = flashdeconv_tpu.FlashDeconv(**FIT, **kw).fit(Y, X, coords)
    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu", **FIT, **kw)
    model.fit(Y, X, coords)
    assert model.solver_dtype == np.float64
    assert model.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(model.beta_, ref.beta_, **F64)
