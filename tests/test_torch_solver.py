"""The port's solver against the JAX package's, on the CPU.

A JAX ``BCDProblem`` prepared for the fused tier (its backend check
faked to "tpu" — gating only, as tests/test_fused_banded.py does) hands
its device operands across with ``problem_from_arrays``; the port then
solves exactly those operands and is held against the JAX one-program
solve in interpret mode. ``bcd_solve`` end to end is held against the
JAX ``bcd_solve``, which runs its XLA banded tier on the CPU.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashdeconv_tpu.core import solver as jsolver
from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.utils.graph import build_knn_graph

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench import make_problem  # noqa: E402

torch.set_num_threads(2)

SIDE = 96  # 9216 spots: above the 8192-spot banded threshold


def _grid_problem(n_types=12, d=64, seed=0, scrambled=False):
    Y, X, coords = make_problem(SIDE * SIDE, n_types, d, seed=seed)
    if scrambled:
        order = np.random.RandomState(seed).permutation(Y.shape[0])
        Y, coords = Y[order], coords[order]
    return Y, X, coords, build_knn_graph(coords, k=6)


@pytest.mark.parametrize("scrambled", [False, True])
def test_fused_solve_on_carried_operands_matches_jax(monkeypatch, scrambled):
    """Same operands, same sweeps: beta to f32 rounding, the same
    iteration count, rel change and objective."""
    Y, X, coords, A = _grid_problem(scrambled=scrambled)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jp = jsolver.BCDProblem(Y, X, A, dtype=np.float32, coords=coords)
    monkeypatch.undo()
    assert jp.use_fused_banded
    assert (jp.perm is not None) == scrambled
    names = ["Xty_t_d", "XtX_d", "masks_d", "nnb_d"]
    if scrambled:
        names.append("_inv_perm_d")
    arrays = {n: np.asarray(getattr(jp, n)) for n in names}
    arrays.update(YtY=jp.YtY, mean_diag=jp.mean_diag)
    tp = tsolver.problem_from_arrays(
        arrays, offsets=jp.offsets, h=jp.h_blocks, block=jp.fused_block,
        n_spots=jp.n_spots, device="cpu",
    )

    lam, rho, tol, max_iter = 0.1, 0.01, 1e-4, 100
    beta_ref, it_ref, rel_ref, obj_ref = jbcd.fused_solve_program(
        None, jp.Xty_t_d, jp.XtX_d, jp.masks_d, jp.nnb_d, jp.YtY_d,
        jp._inv_perm_d if scrambled else None, jnp.float32(lam),
        jnp.float32(rho * jp.mean_diag), jnp.float32(tol),
        jnp.asarray(max_iter, jnp.int32), offsets=jp.offsets,
        max_iter=max_iter, h=jp.h_blocks, block=jp.fused_block,
        n_spots=jp.n_spots, interpret=True,
    )
    beta, info = tp.solve(lambda_=lam, rho=rho, max_iter=max_iter, tol=tol)
    assert info["converged"]
    assert info["n_iterations"] == int(it_ref)
    np.testing.assert_allclose(beta, np.asarray(beta_ref), atol=2e-5)
    # The last rel change is max|delta beta| / max|beta| ~ 1e-5: a
    # difference of nearly equal f32 numbers, so ulp-level differences in
    # beta show up at ~1e-4 relative in it.
    np.testing.assert_allclose(info["final_change"], float(rel_ref),
                               rtol=1e-3)
    np.testing.assert_allclose(info["final_objective"], float(obj_ref),
                               rtol=1e-5)


@pytest.mark.parametrize("scrambled", [False, True])
def test_bcd_solve_matches_jax_cpu(scrambled):
    """End to end against the JAX XLA banded tier (its coordinate update
    divides where the fused pass multiplies by a reciprocal: a few ulp
    per sweep, hence 1e-5), cold and warm-started."""
    Y, X, coords, A = _grid_problem(n_types=8, seed=1, scrambled=scrambled)
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4, coords=coords)
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


def test_verbose_samples_the_objective_on_the_reference_cadence(capsys):
    Y, X, coords, A = _grid_problem(n_types=6, seed=2)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-6)
    beta, info = prob.solve(**kw)
    beta_v, info_v = prob.solve(verbose=True, **kw)
    n = info["n_iterations"]
    assert info_v["n_iterations"] == n
    # after sweeps 0, 10, 20, ... and at the converged sweep
    assert len(info_v["objectives"]) == 1 + -(-(n - 1) // 10)
    assert info_v["final_objective"] == info_v["objectives"][-1]
    np.testing.assert_allclose(info_v["final_objective"],
                               info["final_objective"], rtol=1e-6)
    np.testing.assert_array_equal(beta_v, beta)
    assert "Iteration 0: objective" in capsys.readouterr().out


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.resolve_device("cuda")


def test_nonfinite_xty_rows_are_zeroed():
    """A poisoned spot's Xty row is zeroed on the device; the solve stays
    finite and matches the JAX guard's result."""
    Y, X, coords, A = _grid_problem(n_types=6, seed=4)
    Y = Y.copy()
    Y[[5, 700]] = np.nan
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4, coords=coords)
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert prob.n_nonfinite_spots == 2
    beta, info = prob.solve(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4)
    ref, rinfo = jsolver.bcd_solve(Y, X, A, **kw)
    assert np.isfinite(beta).all() and np.isfinite(info["final_objective"])
    assert info["n_iterations"] == rinfo["n_iterations"]
    np.testing.assert_allclose(beta, ref, atol=1e-5)


def test_normalize_proportions_device_matches_jax():
    rng = np.random.RandomState(5)
    beta = np.abs(rng.randn(50, 7)).astype(np.float32)
    beta[[3, 17]] = 0.0
    ref = jsolver.normalize_proportions_device(jnp.asarray(beta))
    out = tsolver.normalize_proportions_device(torch.from_numpy(beta))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(out.numpy(),
                               jsolver.normalize_proportions(beta), rtol=1e-6)
