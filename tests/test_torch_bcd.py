"""The port's plain PyTorch BCD layer against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
``flashdeconv_tpu.ops.bcd`` (the Pallas sweep in interpret mode) and
``flashdeconv_tpu_torch.ops.bcd`` (the plain version the kernel wrapper
runs for a CPU tensor). Tolerances are those of tests/test_fused_banded.py:
both sides are f32 and differ only in the order of sums inside matmuls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu_torch.ops import bcd as tbcd
from torch_problems import BLOCK, as_torch, fused_problem

torch.set_num_threads(2)


def as_jax(p):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in p.items()}


def _gs_args(K, B=256, seed=0):
    rng = np.random.RandomState(seed)
    Xs = rng.randn(K, 2 * K)
    xtx = (Xs @ Xs.T).astype(np.float32)
    nnb = rng.randint(0, 7, size=(1, B)).astype(np.float32)
    return (
        np.abs(rng.randn(K, B)).astype(np.float32),
        (np.abs(rng.randn(K, B)) * 5).astype(np.float32),
        xtx,
        np.abs(rng.randn(K, B)).astype(np.float32),
        nnb,
    )


def test_gs_inv_den_matches_jax():
    beta, xty, xtx, ns, nnb = _gs_args(20)
    nnb[0, :5] = 0.0
    xtx[3, 3] = 0.0  # guarded: den <= 1e-10 -> 0 where the degree is 0
    ref = jbcd.gs_inv_den(jnp.asarray(xtx), jnp.asarray(nnb), jnp.float32(0.7))
    out = tbcd.gs_inv_den(torch.from_numpy(xtx), torch.from_numpy(nnb), 0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    assert out[3, 0] == 0.0


@pytest.mark.parametrize("K", [6, 20, 72, 65, 96, 128, 160, 256])
def test_gs_pass_matches_jax(K):
    """Classic pass (K = 6), panel 8 (K = 20), panel 16 (K = 65 to 256:
    the bounds of the JAX package's test_panel_pass_matches_classic_pass)."""
    beta, xty, xtx, ns, nnb = _gs_args(K, seed=K)
    lam, rho = 0.7, 0.15
    jinv = jbcd.gs_inv_den(jnp.asarray(xtx), jnp.asarray(nnb), jnp.float32(lam))
    ref = jbcd.gs_pass(
        jnp.asarray(beta), jnp.asarray(xty), jnp.asarray(xtx),
        jnp.asarray(ns), jinv, jnp.float32(lam), jnp.float32(rho),
    )
    t = torch.from_numpy
    tinv = tbcd.gs_inv_den(t(xtx), t(nnb), lam)
    out = tbcd.gs_pass(t(beta), t(xty), t(xtx), t(ns), tinv, lam, rho)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)
    assert (out >= 0).all()


def test_gs_pass_dispatch_widths():
    assert tbcd._gs_panel_width(8) is None
    assert tbcd._gs_panel_width(9) == 8
    assert tbcd._gs_panel_width(64) == 8
    assert tbcd._gs_panel_width(65) == 16
    assert tbcd._gs_panel_width(256) == 16


def test_carry_roundtrip_matches_jax():
    rng = np.random.RandomState(0)
    beta = rng.randn(4 * BLOCK, 9).astype(np.float32)
    carry = tbcd.to_fused_carry(torch.from_numpy(beta), 2, BLOCK)
    ref = jbcd.to_fused_carry(jnp.asarray(beta), 2, BLOCK)
    np.testing.assert_array_equal(carry.numpy(), np.asarray(ref))
    back = tbcd.from_fused_carry(carry, 2, BLOCK)
    np.testing.assert_array_equal(back.numpy(), beta)


def _jax_sweep(jp, lam, rho):
    inv = jbcd.gs_inv_den(jp["XtX"], jp["nnb"], jnp.float32(lam))
    return jbcd.fused_banded_sweep(
        jp["carry"], jp["Xty_t"], jp["XtX"], jp["masks"], inv,
        jnp.float32(lam), jnp.float32(rho), jp["offsets"], jp["h"],
        block=BLOCK, interpret=True,
    )


@pytest.mark.parametrize("K", [6, 20, 96])
def test_fused_sweep_reference_matches_jax_interpret(K):
    """64 x 64 grids; the 32 x 32 grid at K = 96 (panels of 16) keeps
    interpret mode fast."""
    p = fused_problem(side=32 if K > 64 else 64, n_types=K, seed=K)
    lam, rho = 0.5, 0.1
    ref, rd, ra = _jax_sweep(as_jax(p), lam, rho)
    tp = as_torch(p)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], lam)
    out, d, a = tbcd.fused_banded_sweep_reference(
        tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, lam, rho,
        p["offsets"], p["h"], BLOCK,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(float(d), float(rd), atol=2e-5)
    np.testing.assert_allclose(float(a), float(ra), atol=2e-5)
    pad = p["h"] * BLOCK
    assert (out[:, :pad] == 0).all() and (out[:, -pad:] == 0).all()
    assert (out >= 0).all()


def test_wrapper_runs_plain_version_on_cpu():
    """A CPU carry takes the plain version — into the given out buffer,
    bit for bit — and launches no kernel."""
    p = fused_problem(n_types=20, seed=2)
    tp = as_torch(p)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.3)
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.3, 0.05,
            p["offsets"], p["h"], BLOCK)
    before = tbcd.fused_banded_sweep.launches
    out = torch.full_like(tp["carry"], 7.0)  # pad slabs must be rewritten
    got, d, a = tbcd.fused_banded_sweep(*args, out=out)
    ref, rd, ra = tbcd.fused_banded_sweep_reference(*args)
    assert got is out
    assert torch.equal(got, ref) and d == rd and a == ra
    assert tbcd.fused_banded_sweep.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    p = fused_problem(n_types=6, seed=4)
    tp = as_torch(p)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.3)

    def sweep(carry=tp["carry"], masks=tp["masks"], out=None, offsets=None):
        return tbcd.fused_banded_sweep(
            carry, tp["Xty_t"], tp["XtX"], masks, inv, 0.3, 0.05,
            offsets or p["offsets"], p["h"], BLOCK, out=out,
        )

    with pytest.raises(ValueError, match="Jacobi"):
        sweep(out=tp["carry"])
    with pytest.raises(ValueError, match="masks"):
        sweep(masks=tp["masks"].float())
    with pytest.raises(ValueError, match="pad"):
        sweep(offsets=(1, p["h"] * BLOCK + 1) + p["offsets"][2:])
    with pytest.raises(ValueError, match="contiguous"):
        sweep(carry=tp["carry"].T.contiguous().T)


def test_iterate_matches_jax_interpret():
    """Four sweeps (tol 1e-30 never stops the loop): the same iteration
    count, the same carry to f32 rounding."""
    p = fused_problem(n_types=20, seed=7)
    lam, rho = 0.8, 0.3
    jp = as_jax(p)
    ref, it_ref, rel_ref = jbcd.bcd_iterate_banded_fused(
        jp["carry"], jp["Xty_t"], jp["XtX"], jp["masks"], jp["nnb"],
        jnp.float32(lam), jnp.float32(rho), jnp.float32(1e-30), 4,
        p["offsets"], p["h"], block=BLOCK, interpret=True,
    )
    tp = as_torch(p)
    out, it, rel = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"],
        lam, rho, 1e-30, 4, p["offsets"], p["h"], BLOCK,
    )
    assert it == int(it_ref) == 4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    np.testing.assert_allclose(rel, float(rel_ref), rtol=1e-4)


def test_converge_loop_stops_on_the_rule_and_applies_the_sweep():
    """A loop that stops on tol counts the satisfying sweep; a max_iter
    below that count stops it first."""
    p = fused_problem(n_types=6, seed=8)
    tp = as_torch(p)
    args = (tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"], 0.5, 0.05)
    _, it_full, rel_full = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), *args, 1e-3, 200, p["offsets"], p["h"], BLOCK,
    )
    assert 1 < it_full < 200 and rel_full < 1e-3
    _, it_cap, rel_cap = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), *args, 1e-3, it_full - 1, p["offsets"], p["h"],
        BLOCK,
    )
    assert it_cap == it_full - 1 and rel_cap >= 1e-3


def test_objective_matches_jax():
    p = fused_problem(n_types=20, seed=9)
    lam, rho, yty = 0.5, 0.1, 5.0e6
    jp = as_jax(p)
    ref = jbcd.objective_terms_banded_fused(
        jp["carry"], jp["Xty_t"], jp["XtX"], jnp.float32(yty), p["offsets"],
        jp["masks"], jnp.float32(lam), jnp.float32(rho), p["h"], BLOCK,
        nnb=jp["nnb"],
    )
    tp = as_torch(p)
    out = tbcd.objective_terms_banded_fused(
        tp["carry"], tp["Xty_t"], tp["XtX"], yty, p["offsets"],
        tp["masks"], lam, rho, p["h"], BLOCK, nnb=tp["nnb"],
    )
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-5)


def test_fused_solve_matches_jax_program():
    """The whole solve (uniform init over n_spots, loop, objective, un-pad,
    un-permute) against the JAX one-program solve in interpret mode."""
    p = fused_problem(n_types=8, seed=5)
    n, K = p["Xty_t"].shape[1], p["Xty_t"].shape[0]
    n_spots = n - 7
    p["Xty_t"][:, n_spots:] = 0.0
    p["masks"][:, n_spots:] = 0
    rng = np.random.RandomState(11)
    perm = rng.permutation(n_spots)
    inv = np.empty(n_spots, dtype=np.int64)
    inv[perm] = np.arange(n_spots)
    lam, rho, tol, yty = 0.5, 0.1, 1e-30, 37.5
    jp = as_jax(p)
    beta_ref, it_ref, rel_ref, obj_ref = jbcd.fused_solve_program(
        None, jp["Xty_t"], jp["XtX"], jp["masks"], jp["nnb"],
        jnp.float32(yty), jnp.asarray(inv.astype(np.int32)),
        jnp.float32(lam), jnp.float32(rho), jnp.float32(tol),
        jnp.asarray(3, jnp.int32), offsets=p["offsets"], max_iter=3,
        h=p["h"], block=BLOCK, n_spots=n_spots, interpret=True,
    )
    tp = as_torch(p)
    tier = tbcd.FusedBandedTier(
        Xty_t=tp["Xty_t"], XtX=tp["XtX"], nnb=tp["nnb"], YtY=yty,
        masks=tp["masks"], offsets=p["offsets"], h=p["h"], block=BLOCK,
    )
    beta, it, rel, converged, objectives = tbcd.fused_solve(
        None, tier, torch.from_numpy(inv), lam, rho, tol, 3, n_spots,
    )
    assert beta.shape == (n_spots, K)
    assert it == int(it_ref) == 3 and not converged
    np.testing.assert_allclose(beta.numpy(), np.asarray(beta_ref), atol=2e-5)
    np.testing.assert_allclose(rel, float(rel_ref), rtol=1e-4)
    assert len(objectives) == 1  # one chunk of max_iter sweeps
    np.testing.assert_allclose(objectives[-1], float(obj_ref), rtol=1e-5)
