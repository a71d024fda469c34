"""The port's gather and unfused banded tiers against the JAX package's,
on the CPU.

The same seeded numpy inputs go through ``flashdeconv_tpu`` and
``flashdeconv_tpu_torch``. The neighbour sums are bitwise equal (same slot
and band order). The coordinate-descent kernel's plain version is held
against the JAX Pallas block kernel in interpret mode. Whole solves are
held against JAX ``bcd_solve``, which on the CPU runs its XLA
``coordinate_descent``: it divides where the port's pass multiplies by the
per-solve reciprocal, a few ulp per sweep — hence beta atol 1e-5, the
bound of ``benchmarks/hw_parity.py`` check 2, with the same sweep count.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    adjacency_to_padded_capped,
    banded_split,
    build_knn_graph,
    build_radius_graph,
    grid_coords,
)
from torch_problems import as_torch, fused_problem, with_long_edges

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

torch.set_num_threads(2)


def _irregular(n, seed=0):
    return np.random.RandomState(seed).rand(n, 2) * np.sqrt(n)


def _beta(n, K, seed=0):
    return np.abs(np.random.RandomState(seed).randn(n, K)).astype(np.float32)


def test_neighbor_sum_matches_jax_bitwise():
    coords = _irregular(1500)
    nbr, _ = adjacency_to_padded(build_knn_graph(coords, k=6))
    beta = _beta(1500, 7)
    beta_ext = np.concatenate([beta, np.zeros((1, 7), np.float32)])
    ref = jbcd.neighbor_sum(jnp.asarray(beta_ext), jnp.asarray(nbr))
    out = tbcd.neighbor_sum(
        tbcd.with_sentinel(torch.from_numpy(beta.T.copy())),
        torch.from_numpy(nbr.T.copy()),
    )
    np.testing.assert_array_equal(out.numpy().T, np.asarray(ref))


def test_neighbor_sum_banded_matches_jax_bitwise():
    coords = grid_coords(side=40)
    A = with_long_edges(build_knn_graph(coords, k=6), n_edges=10, seed=1)
    offsets, masks, A_rest = banded_split(A, max_offsets=12, min_coverage=0.5)
    assert A_rest.nnz > 0
    rest, _ = adjacency_to_padded(A_rest)
    beta = _beta(1600, 5, seed=2)
    halo = int(np.max(np.abs(offsets)))
    offs = tuple(int(o) for o in offsets)
    ref = jbcd.neighbor_sum_banded(jnp.asarray(beta), offs,
                                   jnp.asarray(masks), jnp.asarray(rest),
                                   halo)
    out = tbcd.neighbor_sum_banded(
        torch.from_numpy(beta.T.copy()), offs, torch.from_numpy(masks),
        torch.from_numpy(rest.T.copy()),
    )
    np.testing.assert_array_equal(out.numpy().T, np.asarray(ref))


@pytest.mark.parametrize("pad, past_n, nan", [
    (0, False, False),      # the unfused tier: the edge bands clipped
    (6, False, False),      # the banded mesh's window: pad = halo
    (2 * 8, False, False),  # the fused carry: pad = h * block
    (0, True, False),       # one offset reaching past n
    (6, False, True),       # a NaN in the source
])
def test_one_banded_sum_is_the_per_band_loop_bitwise(pad, past_n, nan):
    """The one banded neighbour sum against a per-band loop over each data
    column: from +0.0, bands in ``offsets`` order, ``masks[u, j] *
    src[:, pad + j + off]`` added where the source holds that column."""
    rng = np.random.RandomState(4)
    K, n = 5, 37
    offsets = (-6, -1, 1, 6) + ((n + 3,) if past_n else ())
    src = rng.randn(K, n + 2 * pad).astype(np.float32)
    if nan:
        src[2, pad + 10] = np.nan
    masks = (rng.rand(len(offsets), n) < 0.7).astype(np.float32)
    got = tbcd._banded_neighbor_sum(torch.from_numpy(src),
                                    torch.from_numpy(masks), offsets,
                                    pad).numpy()
    ref = np.zeros((K, n), np.float32)
    for u, off in enumerate(offsets):
        for j in range(n):
            if 0 <= pad + j + off < src.shape[1]:
                ref[:, j] = ref[:, j] + masks[u, j] * src[:, pad + j + off]
    assert np.isnan(ref).any() == nan
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got.view(np.uint32)[~np.isnan(ref)],
                                  ref.view(np.uint32)[~np.isnan(ref)])


def test_overflow_sum_matches_jax_segment_sum():
    coords = _irregular(1200, seed=3)
    A = build_radius_graph(coords, radius=2.5)
    nbr, counts, ov_src, ov_dst = adjacency_to_padded_capped(A, max_degree=8)
    assert ov_src.size > 0
    beta = _beta(1200, 6, seed=4)
    beta_ext = np.concatenate([beta, np.zeros((1, 6), np.float32)])
    ref = jbcd.overflow_sum(jnp.asarray(beta_ext), jnp.asarray(ov_src),
                            jnp.asarray(ov_dst), 1200)
    rows, table = tbcd.overflow_table(ov_src, ov_dst, 1200)
    np.testing.assert_array_equal(rows, np.unique(ov_src))
    sums = tbcd.overflow_sum(
        tbcd.with_sentinel(torch.from_numpy(beta.T.copy())),
        torch.from_numpy(table),
    )
    out = np.zeros((6, 1200), np.float32)
    out[:, rows] = sums.numpy()
    np.testing.assert_allclose(out.T, np.asarray(ref), atol=1e-6, rtol=0)


def test_overflow_table_groups_edges_by_spot_in_edge_order():
    rows, table = tbcd.overflow_table(np.array([5, 2, 5, 9, 5]),
                                      np.array([1, 3, 4, 0, 7]), 10)
    np.testing.assert_array_equal(rows, [2, 5, 9])
    np.testing.assert_array_equal(table, [[3, 1, 0], [10, 4, 10],
                                          [10, 7, 10]])


@pytest.mark.parametrize("K", [6, 20, 64, 96, 128])
def test_cd_block_reference_matches_jax_pallas_interpret(K):
    """The plain version of the kernel against the Pallas block kernel:
    the same GS pass (classic at K <= 8, panels of 8 through K = 64, of 16
    above), f32 sums in another order inside the matmuls."""
    n = 2048
    rng = np.random.RandomState(K)
    Xs = rng.randn(K, 2 * K + 8)
    XtX = (Xs @ Xs.T).astype(np.float32)
    beta, ns = _beta(n, K, seed=K), _beta(n, K, seed=K + 1)
    xty = (np.abs(rng.randn(n, K)) * 5).astype(np.float32)
    nnb = rng.randint(0, 9, size=n).astype(np.float32)
    lam, rho = 0.4, 0.2
    jinv = jbcd.gs_inv_den(jnp.asarray(XtX), jnp.asarray(nnb),
                           jnp.float32(lam))
    ref = jbcd.coordinate_descent_pallas(
        jnp.asarray(beta), jnp.asarray(xty), jnp.asarray(XtX),
        jnp.asarray(ns), jnp.asarray(nnb), jnp.float32(lam),
        jnp.float32(rho), interpret=True, inv_den=jinv,
    )
    t = torch.from_numpy
    inv = tbcd.gs_inv_den(t(XtX), t(nnb), lam)
    out, d, a = tbcd.coordinate_descent_block_reference(
        t(beta.T.copy()), t(xty.T.copy()), t(XtX), t(ns.T.copy()), inv,
        lam, rho,
    )
    np.testing.assert_allclose(out.numpy().T, np.asarray(ref), atol=2e-5)
    ref_d, ref_a = jbcd.sweep_stats(ref, jnp.asarray(beta))
    np.testing.assert_allclose(float(d), float(ref_d), atol=2e-5)
    assert float(a) == float(ref_a)


def test_wrapper_runs_plain_version_on_cpu():
    """A CPU tensor takes the plain version, into the given out buffer bit
    for bit, and launches no kernel; bad operands raise."""
    K, n = 9, 700
    rng = np.random.RandomState(5)
    Xs = rng.randn(K, 20)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    XtX = t(Xs @ Xs.T)
    beta, xty, ns = t(_beta(n, K).T), t(_beta(n, K, 1).T), t(_beta(n, K, 2).T)
    inv = tbcd.gs_inv_den(XtX, torch.full((n,), 4.0), 0.3)
    args = (beta, xty, XtX, ns, inv, 0.3, 0.05)
    before = tbcd.coordinate_descent_block.launches
    out = torch.full_like(beta, 7.0)
    got, d, a = tbcd.coordinate_descent_block(*args, out=out)
    ref, rd, ra = tbcd.coordinate_descent_block_reference(*args)
    assert got is out and torch.equal(got, ref) and d == rd and a == ra
    assert tbcd.coordinate_descent_block.launches == before
    with pytest.raises(ValueError, match="Jacobi"):
        tbcd.coordinate_descent_block(*args, out=beta)
    with pytest.raises(ValueError, match="contiguous"):
        tbcd.coordinate_descent_block(beta, xty, XtX, ns.T.contiguous().T,
                                      inv, 0.3, 0.05)
    K = tbcd.KERNEL_MAX_K + 1
    with pytest.raises(ValueError, match=f"K <= {tbcd.KERNEL_MAX_K}"):
        big = torch.zeros((K, 4))
        tbcd.coordinate_descent_block(big, big, torch.zeros((K, K)), big,
                                      big, 0.3, 0.05)


def _case(case):
    """(Y_sketch, X_sketch, coords, A, max_degree, expected tier)."""
    if case == "irregular":
        Y, X, _ = make_problem(3000, 8, 64, seed=1)
        coords = _irregular(3000, seed=1)
        return Y, X, coords, build_knn_graph(coords, k=6), None, "gather"
    if case in ("few_spots", "grid_2500"):
        side = 20 if case == "few_spots" else 50
        Y, X, coords = make_problem(side * side, 8, 64, seed=2)
        return Y, X, coords, build_knn_graph(coords, k=6), None, "gather"
    if case == "radius_capped":
        Y, X, _ = make_problem(2000, 6, 48, seed=3)
        coords = _irregular(2000, seed=3)
        return (Y, X, coords, build_radius_graph(coords, radius=2.0), 10,
                "gather")
    if case == "not_banded":
        Y, X, _ = make_problem(96 * 96, 8, 32, seed=4)
        coords = _irregular(96 * 96, seed=4)
        return Y, X, coords, build_knn_graph(coords, k=6), None, "gather"
    # rest_stream: a grid with long-range edges off the bands, a remainder
    # over the fused tier's 2 % gate (800 edges) or under it (40 edges)
    Y, X, coords = make_problem(96 * 96, 8, 64, seed=1)
    if case == "rest_stream":
        A = with_long_edges(build_knn_graph(coords, k=6), n_edges=800)
        return Y, X, coords, A, None, "banded"
    A = with_long_edges(build_knn_graph(coords, k=6))
    return Y, X, coords, A, None, "fused"


@pytest.mark.parametrize("case", [
    "irregular", "few_spots", "grid_2500", "radius_capped", "not_banded",
    "rest_stream", "rest_stream_fused",
])
def test_bcd_solve_matches_jax_cpu(case):
    """Cold and warm-started solves: the same sweeps, beta within 1e-5,
    the objective within 1e-5 relative."""
    Y, X, coords, A, max_degree, tier = _case(case)
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4, coords=coords,
              max_degree=max_degree)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords,
                               max_degree=max_degree, device="cpu")
    assert prob.use_fused_banded == (tier == "fused")
    assert prob.use_banded == (tier in ("banded", "fused"))
    if tier == "fused":
        assert prob.tier.rest_touched is not None
    if case == "radius_capped":
        assert prob.tier.overflow is not None
    ref, rinfo = jsolver.bcd_solve(Y, X, A, **kw)
    beta, info = tsolver.bcd_solve(Y, X, A, device="cpu", **kw)
    assert info["converged"] and rinfo["converged"]
    assert info["n_iterations"] == rinfo["n_iterations"]
    np.testing.assert_allclose(beta, ref, atol=1e-5)
    np.testing.assert_allclose(info["final_objective"],
                               rinfo["final_objective"], rtol=1e-5)

    init = np.clip(ref + 0.01, 0.0, None)
    ref_w, rinfo_w = jsolver.bcd_solve(Y, X, A, beta_init=init, **kw)
    beta_w, info_w = tsolver.bcd_solve(Y, X, A, beta_init=init,
                                       device="cpu", **kw)
    assert info_w["n_iterations"] == rinfo_w["n_iterations"]
    np.testing.assert_allclose(beta_w, ref_w, atol=1e-5)
    np.testing.assert_allclose(info_w["final_objective"],
                               rinfo_w["final_objective"], rtol=1e-5)


def test_gather_verbose_samples_the_objective_on_the_reference_cadence(
        capsys):
    Y, X, coords, A, _, _ = _case("irregular")
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-6)
    beta, info = prob.solve(**kw)
    beta_v, info_v = prob.solve(verbose=True, **kw)
    n = info["n_iterations"]
    assert info_v["n_iterations"] == n
    assert len(info_v["objectives"]) == 1 + -(-(n - 1) // 10)
    np.testing.assert_array_equal(beta_v, beta)
    assert "Iteration 0: objective" in capsys.readouterr().out


def test_fused_and_unfused_banded_solves_are_bitwise_equal():
    """The same wholly banded operands through the fused carry and through
    the unfused (K, n) carry: the same sweeps and the same beta, bit for
    bit, as the two kernels are on the card."""
    p = fused_problem(n_types=12, seed=6)
    tp = as_torch(p)
    n = p["Xty_t"].shape[1]
    pad = p["h"] * p["block"]
    args = (0.5, 0.05, 1e-30, 8)
    carry, it_f, rel_f = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"],
        *args, p["offsets"], p["h"], p["block"],
    )
    beta_t, it_u, rel_u = tbcd.bcd_iterate_banded(
        tp["carry"][:, pad:pad + n].contiguous(), tp["Xty_t"], tp["XtX"],
        p["offsets"], tp["masks"].float(), torch.zeros((0, n), dtype=torch.int32),
        tp["nnb"], *args,
    )
    assert it_f == it_u == 8 and rel_f == rel_u
    assert torch.equal(tbcd.from_fused_carry(carry, p["h"], p["block"]).T,
                       beta_t)


def test_nonfinite_xty_rows_are_zeroed_on_the_gather_tier():
    Y, X, coords, A, _, _ = _case("irregular")
    Y = Y.copy()
    Y[[3, 400]] = np.nan
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4, coords=coords)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert prob.n_nonfinite_spots == 2
    beta, info = prob.solve(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4)
    ref, rinfo = jsolver.bcd_solve(Y, X, A, **kw)
    assert np.isfinite(beta).all() and np.isfinite(info["final_objective"])
    assert info["n_iterations"] == rinfo["n_iterations"]
    np.testing.assert_allclose(beta, ref, atol=1e-5)


@pytest.mark.parametrize("holes", [0, 12])
def test_tissue_masked_grid_takes_the_gather_tier(holes):
    """A grid masked to a disk of tissue (with or without holes), as real
    Stereo-seq and Visium HD sections are: kNN-6 leaves no band that
    covers 90 % of its diagonal, so every edge is a gather edge and the
    section takes the gather tier (in both packages), not a banded one."""
    side = 120
    c = grid_coords(side=side).astype(np.float64)
    keep = ((c - (side - 1) / 2) ** 2).sum(1) <= 0.9 * (side / 2) ** 2
    rng = np.random.RandomState(holes)
    for cx, cy in rng.rand(holes, 2) * side:
        keep &= ((c - (cx, cy)) ** 2).sum(1) > 9.0
    coords = c[keep]
    A = build_knn_graph(coords, k=6)
    offsets, _, rest = banded_split(A, max_offsets=32, min_coverage=0.9)
    assert len(offsets) == 0 and rest.nnz == A.nnz
    rng = np.random.RandomState(1)
    X = rng.randn(4, 16)
    Y = np.abs(rng.randn(coords.shape[0], 4)) @ X
    jprob = jsolver.prepare_bcd(Y, X, A, coords=coords)
    tprob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert not jprob.use_banded and not jprob.use_fused_banded
    assert type(tprob.tier).__name__ == "GatherTier"
