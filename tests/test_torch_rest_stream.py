"""The fused tier's rest stream against the JAX package, on the CPU.

A banded grid whose split leaves a small remainder of rest edges (a grid
with scattered dropped bins, a few long-range edges, or near-empty bands
spilled by the band cap) stays on the fused kernel: a (K, n_solve)
``ns_rest`` buffer, refreshed at the touched spots before each sweep, is
added once after the bands. The same seeded inputs go through
``flashdeconv_tpu`` (its Pallas sweep in interpret mode; its
``BCDProblem`` with the backend check faked to "tpu" for the tier choice,
gating only, as tests/test_fused_banded.py does) and
``flashdeconv_tpu_torch`` (the plain versions a CPU tensor runs).

Tolerances: the host tables and the rest update bitwise; the sweep, the
iterate and a whole solve within atol 2e-5 and the same sweeps (both f32,
differing in the order of sums inside matmuls); the objective rtol 1e-5;
the port's fused tier with the rest stream bitwise its unfused banded tier
on the same decomposition, with the same sweeps.
"""

import sys
from pathlib import Path

import jax
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
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    banded_split,
    build_knn_graph,
    cap_sparse_bands,
    grid_coords,
)
from flashdeconv_tpu_torch.utils.metrics import compute_correlation
from torch_problems import (
    BLOCK,
    as_torch,
    dropped_grid_coords,
    fused_problem,
    with_long_edges,
    with_rest,
)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

torch.set_num_threads(2)

LAM, RHO = 0.6, 0.08


def as_jax(p):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in p.items()}


def capped_problem(side=64, n_types=6, seed=0, block=BLOCK):
    """A grid kNN problem under the band cap, as the JAX package's
    tests/test_fused_banded.py builds it: the near-empty boundary bands
    spilled into a real remainder. Numpy operands on the fused carry
    layout, with the rest table and the rest stream's tables."""
    coords = grid_coords(side=side)
    A = build_knn_graph(coords, k=6)
    n = A.shape[0]
    offsets, masks, A_rest = banded_split(A, max_offsets=32)
    offsets, masks, A_rest = cap_sparse_bands(offsets, masks, A_rest,
                                              int(A.nnz))
    assert A_rest.nnz > 0, "the cap must spill on a finite grid"
    table, _ = adjacency_to_padded(A_rest)
    h = -(-int(np.max(np.abs(offsets))) // block)
    rng = np.random.RandomState(seed)
    beta = np.abs(rng.randn(n, n_types)).astype(np.float32)
    Xs = rng.randn(n_types, 2 * n_types + 8)
    carry = np.zeros((n_types, n + 2 * h * block), np.float32)
    carry[:, h * block:h * block + n] = beta.T
    touched, slots = tbcd.build_fused_rest_tables(table, n, h, block)
    return {
        "carry": carry,
        "Xty_t": (np.abs(rng.randn(n_types, n)) * 5).astype(np.float32),
        "XtX": (Xs @ Xs.T).astype(np.float32),
        "masks": masks.astype(np.uint8),
        "nnb": np.diff(A.tocsr().indptr).astype(np.float32),
        "offsets": tuple(int(o) for o in offsets),
        "h": int(h),
        "block": block,
        "table": table,
        "rest_t": np.ascontiguousarray(table.T.astype(np.int64)),
        "touched": touched.astype(np.int64),
        "slot_cols": slots.astype(np.int64),
    }


def _problem(kind, n_types=6, seed=0):
    if kind == "capped":
        return capped_problem(n_types=n_types, seed=seed)
    return with_rest(fused_problem(side=32 if n_types > 64 else 64,
                                   n_types=n_types, seed=seed), seed=seed)


# -- the host tables and the rest update ---------------------------------------

@pytest.mark.parametrize("kind", ["capped", "random", "empty"])
def test_rest_tables_match_jax(kind):
    """The touched columns (padded to 128 by repeats) and the slots' carry
    columns, bitwise and in the same dtype; (None, None) for no edge."""
    if kind == "empty":
        table, n, h, block = np.full((300, 2), 300, np.int32), 300, 1, 64
    else:
        p = _problem(kind)
        n = p["Xty_t"].shape[1]
        table, h, block = p["rest_t"].T.astype(np.int32), p["h"], p["block"]
        if kind == "capped":
            np.testing.assert_array_equal(table, p["table"])
    got = tbcd.build_fused_rest_tables(table, n, h, block)
    ref = jbcd.build_fused_rest_tables(table, n, h, block)
    if kind == "empty":
        assert got == ref == (None, None)
        return
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.int32
        np.testing.assert_array_equal(g, r)
    assert got[0].size % 128 == 0 and got[1].shape == (table.shape[1],
                                                       got[0].size)


@pytest.mark.parametrize("kind", ["capped", "random"])
def test_rest_ns_update_matches_jax_bitwise(kind):
    """The same carry, the same tables: the same sums in the touched
    columns, +0.0 elsewhere."""
    p = _problem(kind, seed=3)
    K, n = p["Xty_t"].shape
    ref = jbcd.rest_ns_update(jnp.zeros((K, n), jnp.float32),
                              jnp.asarray(p["carry"]),
                              jnp.asarray(p["touched"].astype(np.int32)),
                              jnp.asarray(p["slot_cols"].astype(np.int32)))
    t = as_torch(p)
    buf = torch.zeros((K, n))
    got = tbcd.rest_ns_update(buf, t["carry"], t["touched"], t["slot_cols"])
    assert got is buf
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    untouched = np.setdiff1d(np.arange(n), p["touched"])
    assert (got[:, untouched] == 0).all()
    # ... and the unfused tier's rest sums, bit for bit.
    beta_t = t["carry"][:, p["h"] * p["block"]:][:, :n]
    unfused = tbcd.neighbor_sum(tbcd.with_sentinel(beta_t), t["rest_t"])
    assert torch.equal(got, unfused)


@pytest.mark.parametrize("K", [20, 96])
def test_fused_sweep_reference_with_rest_matches_jax_interpret(K):
    """One sweep with ``ns_rest_t`` against the JAX Pallas sweep in
    interpret mode: atol 2e-5 on the carry and the statistics."""
    p = _problem("random", n_types=K, seed=K)
    jp, t = as_jax(p), as_torch(p)
    nsr = tbcd.rest_ns_update(torch.zeros_like(t["Xty_t"]), t["carry"],
                              t["touched"], t["slot_cols"])
    jinv = jbcd.gs_inv_den(jp["XtX"], jp["nnb"], jnp.float32(LAM))
    ref, rd, ra = jbcd.fused_banded_sweep(
        jp["carry"], jp["Xty_t"], jp["XtX"], jp["masks"], jinv,
        jnp.float32(LAM), jnp.float32(RHO), p["offsets"], p["h"],
        block=p["block"], ns_rest_t=jnp.asarray(nsr.numpy()), interpret=True,
    )
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], LAM)
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, LAM, RHO,
            p["offsets"], p["h"], p["block"])
    out, d, a = tbcd.fused_banded_sweep_reference(*args, ns_rest_t=nsr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(float(d), float(rd), atol=2e-5)
    np.testing.assert_allclose(float(a), float(ra), atol=2e-5)
    # The wrapper on a CPU carry runs that plain version, launching nothing.
    before = tbcd.fused_banded_sweep.rest_launches
    wrapped = tbcd.fused_banded_sweep(*args, ns_rest_t=nsr)
    assert torch.equal(wrapped[0], out)
    assert tbcd.fused_banded_sweep.rest_launches == before
    # The rest input changes the sweep (it is not dropped on the way).
    assert not torch.equal(tbcd.fused_banded_sweep_reference(*args)[0], out)


def test_wrapper_checks_the_rest_input():
    p = _problem("random", n_types=6)
    t = as_torch(p)
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], LAM)
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, LAM, RHO,
            p["offsets"], p["h"], p["block"])
    K, n = p["Xty_t"].shape
    for bad, match in ((torch.zeros((K, n - 1)), "ns_rest_t: expected"),
                       (torch.zeros((K, n), dtype=torch.float64),
                        "ns_rest_t: expected"),
                       (torch.zeros((n, K)).T, "ns_rest_t must be contig")):
        with pytest.raises(ValueError, match=match):
            tbcd.fused_banded_sweep(*args, ns_rest_t=bad)


# -- the loop, the objective and the tier ----------------------------------------

def test_fused_rest_iterate_matches_jax_interpret():
    """Four sweeps of the capped grid through the rest stream (JAX
    tests/test_fused_banded.py::test_capped_fused_matches_unfused_banded_
    plus_rest): the same sweep count, the carry within atol 2e-5."""
    p = capped_problem(seed=7)
    jp, t = as_jax(p), as_torch(p)
    iters = 4
    ref, it_ref, rel_ref = jbcd.bcd_iterate_banded_fused(
        jp["carry"], jp["Xty_t"], jp["XtX"], jp["masks"], jp["nnb"],
        jnp.float32(LAM), jnp.float32(RHO), jnp.float32(1e-30), iters,
        p["offsets"], p["h"], block=p["block"],
        rest_touched=jnp.asarray(p["touched"].astype(np.int32)),
        rest_slot_cols=jnp.asarray(p["slot_cols"].astype(np.int32)),
        interpret=True,
    )
    carry, it, rel = tbcd.bcd_iterate_banded_fused(
        t["carry"].clone(), t["Xty_t"], t["XtX"], t["masks"], t["nnb"], LAM,
        RHO, 1e-30, iters, p["offsets"], p["h"], p["block"],
        rest_touched=t["touched"], rest_slot_cols=t["slot_cols"],
    )
    assert it == int(it_ref) == iters
    np.testing.assert_allclose(carry.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(rel, float(rel_ref), rtol=1e-4)


def test_objective_with_rest_matches_jax():
    """rtol 1e-5 against JAX; bitwise the unfused tier's objective."""
    p = capped_problem(seed=9)
    jp, t = as_jax(p), as_torch(p)
    yty = 5e3
    ref = jbcd.objective_terms_banded_fused(
        jp["carry"], jp["Xty_t"], jp["XtX"], jnp.float32(yty), p["offsets"],
        jp["masks"], jnp.float32(0.7), jnp.float32(0.2), p["h"], p["block"],
        nnb=jp["nnb"], rest_touched=jnp.asarray(p["touched"].astype(np.int32)),
        rest_slot_cols=jnp.asarray(p["slot_cols"].astype(np.int32)),
    )
    tier = tbcd.FusedBandedTier(
        Xty_t=t["Xty_t"], XtX=t["XtX"], nnb=t["nnb"], YtY=yty,
        masks=t["masks"], offsets=p["offsets"], h=p["h"], block=p["block"],
        rest_touched=t["touched"], rest_slot_cols=t["slot_cols"])
    out = tier.objective(t["carry"], 0.7, 0.2)
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)
    unfused = tier.unfused()
    assert torch.equal(unfused.objective(tier.beta(t["carry"]).T
                                         .contiguous(), 0.7, 0.2), out)
    plain = dict(vars(tier), rest_touched=None, rest_slot_cols=None)
    assert float(tbcd.FusedBandedTier(**plain).objective(
        t["carry"], 0.7, 0.2)) != float(out)


@pytest.mark.parametrize("kind", ["capped", "random"])
@pytest.mark.parametrize("K", [6, 20, 96])
def test_fused_rest_is_bitwise_the_unfused_banded_tier(kind, K):
    """Whole solves (tol 1e-4) through ``fused_solve``: the fused tier with
    the rest stream, the unfused banded tier made from it, and one built
    from the padded rest table itself give the same sweeps, rel change,
    objectives and beta, bit for bit."""
    p = _problem(kind, n_types=K, seed=K + 1)
    t = as_torch(p)
    n = p["Xty_t"].shape[1]
    fused = tbcd.FusedBandedTier(
        Xty_t=t["Xty_t"], XtX=t["XtX"], nnb=t["nnb"], YtY=1e4,
        masks=t["masks"], offsets=p["offsets"], h=p["h"], block=p["block"],
        rest_touched=t["touched"], rest_slot_cols=t["slot_cols"])
    own = tbcd.BandedTier(Xty_t=t["Xty_t"], XtX=t["XtX"], nnb=t["nnb"],
                          YtY=1e4, masks=t["masks"].float(),
                          offsets=p["offsets"], rest=t["rest_t"])
    made = fused.unfused()
    assert torch.equal(made.rest, t["rest_t"])
    beta0 = torch.from_numpy(p["carry"][:, p["h"] * p["block"]:][:, :n].T
                             .copy())
    runs = [tbcd.fused_solve(beta0.clone(), tier, None, LAM, RHO, 1e-4, 60,
                             n) for tier in (fused, made, own)]
    b0, it0, rel0, conv0, obj0 = runs[0]
    assert it0 > 1
    for b, it, rel, conv, obj in runs[1:]:
        assert (it, rel, conv, obj) == (it0, rel0, conv0, obj0)
        assert torch.equal(b, b0)


CASES = {
    # case: (coords, long edges, expected tier)
    "long_edges_96": (grid_coords(side=96), 40, "fused_rest"),
    "long_edges_96_over_gate": (grid_coords(side=96), 800, "banded"),
    "dropped_256_1pct": (dropped_grid_coords(256, 0.01), 0, "fused_rest"),
    "dropped_256_5pct": (dropped_grid_coords(256, 0.05), 0, "banded"),
    "rescue_512": (grid_coords(side=512), "rescue", "fused_rest"),
}


def _case_graph(case):
    coords, extra, tier = CASES[case]
    A = build_knn_graph(coords, k=6)
    if extra == "rescue":
        # tests/test_fused_banded.py::test_bcd_problem_fused_plan_rescue:
        # 30 edges from the first half, 60,000-120,000 spots away.
        from scipy import sparse

        n = A.shape[0]
        rng = np.random.RandomState(1)
        src = rng.choice(n // 2, 30, replace=False)
        dst = src + rng.randint(60_000, 120_000, size=30)
        A = ((A + sparse.coo_matrix(
            (np.ones(60), (np.r_[src, dst], np.r_[dst, src])), shape=(n, n)
        ).tocsr()) > 0).astype(np.float64)
    elif extra:
        A = with_long_edges(A, n_edges=extra)
    return coords, A, tier


@pytest.mark.parametrize("case", sorted(CASES))
def test_tier_choice_matches_jax(monkeypatch, case):
    """The port's ``BCDProblem`` takes the fused tier with rest tables
    exactly where the JAX one (backend faked to "tpu") sets
    ``use_fused_banded`` with ``rest_touched_d``, with the same bands, halo,
    masks, degrees and rest tables; the unfused banded tier where JAX takes
    its unfused banded tier, with the same rest table."""
    coords, A, tier = _case_graph(case)
    n = A.shape[0]
    rng = np.random.RandomState(0)
    Y, X = rng.randn(n, 32), rng.randn(12, 32)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jp = jsolver.BCDProblem(Y, X, A, dtype=np.float32, coords=coords)
    monkeypatch.undo()
    tp = tsolver.BCDProblem(Y, X, A, coords=coords, device="cpu")
    assert jp.use_banded and tp.use_banded
    assert tp.use_fused_banded == jp.use_fused_banded == (tier != "banded")
    if tier == "banded":
        # JAX pads its unfused tier to the 2048-spot block of its Pallas
        # coordinate-descent kernel; the port's unfused tier is unpadded.
        np.testing.assert_array_equal(tp.tier.rest.numpy().T,
                                      np.asarray(jp.rest_d)[:n])
        np.testing.assert_array_equal(tp.tier.masks.numpy(),
                                      np.asarray(jp.masks_d)[:, :n])
        assert tp.tier.offsets == jp.offsets
        return
    t = tp.tier
    assert jp.fused_block == t.block == tsolver.FUSED_BLOCK
    assert (t.offsets, t.h) == (jp.offsets, jp.h_blocks)
    if case == "rescue_512":
        assert jp.halo < 4096 and max(abs(o) for o in t.offsets) < 4096
    assert jp.rest_touched_d is not None and t.rest_touched is not None
    for got, ref in ((t.rest_touched, jp.rest_touched_d),
                     (t.rest_slot_cols, jp.rest_slots_d),
                     (t.masks, jp.masks_d), (t.nnb, jp.nnb_d)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_allclose(t.Xty_t.numpy(), np.asarray(jp.Xty_t_d),
                               rtol=1e-6, atol=1e-6)


def test_problem_from_arrays_with_rest_matches_jax_solve_program(monkeypatch):
    """JAX's fused operands and rest tables of the 96 x 96 grid with 40 long
    edges, solved by the port and by the JAX one-program solve in interpret
    mode: the same sweeps, beta within atol 2e-5, the objective rtol
    1e-5."""
    Y, X, coords = make_problem(96 * 96, 12, 64, seed=3)
    A = with_long_edges(build_knn_graph(coords, k=6))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jp = jsolver.BCDProblem(Y, X, A, dtype=np.float32, coords=coords)
    monkeypatch.undo()
    assert jp.use_fused_banded and jp.rest_touched_d is not None
    names = ["Xty_t_d", "XtX_d", "masks_d", "nnb_d", "rest_touched_d",
             "rest_slots_d"]
    arrays = {k: np.asarray(getattr(jp, k)) for k in names}
    arrays.update(YtY=jp.YtY, mean_diag=jp.mean_diag)
    tp = tsolver.problem_from_arrays(
        arrays, offsets=jp.offsets, h=jp.h_blocks, block=jp.fused_block,
        n_spots=jp.n_spots, device="cpu")
    assert tp.tier.rest_touched is not None

    lam, rho, tol, max_iter = 0.1, 0.01, 1e-4, 100
    beta_ref, it_ref, rel_ref, obj_ref = jbcd.fused_solve_program(
        None, jp.Xty_t_d, jp.XtX_d, jp.masks_d, jp.nnb_d, jp.YtY_d, None,
        jnp.float32(lam), jnp.float32(rho * jp.mean_diag), jnp.float32(tol),
        jnp.asarray(max_iter, jnp.int32), offsets=jp.offsets,
        max_iter=max_iter, h=jp.h_blocks, block=jp.fused_block,
        n_spots=jp.n_spots, rest_touched=jp.rest_touched_d,
        rest_slot_cols=jp.rest_slots_d, interpret=True,
    )
    calls = []
    real = tbcd.rest_ns_update
    monkeypatch.setattr(tbcd, "rest_ns_update",
                        lambda *a: calls.append(1) or real(*a))
    beta, info = tp.solve(lambda_=lam, rho=rho, max_iter=max_iter, tol=tol)
    assert info["converged"]
    assert info["n_iterations"] == int(it_ref)
    # one refresh a sweep, one for the final objective
    assert len(calls) == info["n_iterations"] + 1
    np.testing.assert_allclose(beta, np.asarray(beta_ref), atol=2e-5)
    np.testing.assert_allclose(info["final_objective"], float(obj_ref),
                               rtol=1e-5)


def test_dropped_grid_fit_takes_the_rest_stream_and_matches_jax(monkeypatch):
    """A 96 x 96 grid of counts with 1 % of its bins dropped: the port's fit
    streams the rest edges on its fused tier, the JAX fit runs its XLA
    banded tier on the CPU; the same genes, lambda and sweeps, proportions
    within 1e-4 (the bound of tests/test_torch_deconv.py), Pearson > 0.9."""
    Y, X, coords, truth = make_synthetic(n_spots=9216, n_genes=600,
                                         n_types=8, seed=2,
                                         sparse_output=True)
    keep = np.random.RandomState(0).rand(Y.shape[0]) >= 0.01
    Y, coords, truth = Y[keep], coords[keep], truth[keep]
    ref = flashdeconv_tpu.FlashDeconv().fit(Y, X, coords)
    calls = []
    real = tbcd.rest_ns_update
    monkeypatch.setattr(tbcd, "rest_ns_update",
                        lambda *a: calls.append(1) or real(*a))
    port = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    props = port.fit_transform(Y, X, coords)
    assert len(calls) == port.info_["n_iterations"] + 1
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    assert port.lambda_used_ == ref.lambda_used_
    assert port.info_["converged"] and ref.info_["converged"]
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    np.testing.assert_allclose(props, ref.proportions_, atol=1e-4)
    np.testing.assert_allclose(port.info_["final_objective"],
                               ref.info_["final_objective"], rtol=1e-5)
    assert compute_correlation(props, truth) > 0.9
