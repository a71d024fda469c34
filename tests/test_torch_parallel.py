"""The port's spot-sharded solves against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``flashdeconv_tpu.parallel`` on 2
and 4 of the virtual CPU devices of tests/conftest.py and through
``flashdeconv_tpu_torch.parallel`` on a mesh of 2 and 4 CPU shards (one
device named several times). The host plans are copies, so they agree bit
for bit. The solves are both f32 and agree to 1e-5 on beta with the same
sweeps (the bound of ROADMAP.md): the JAX package runs its XLA tiers, or
the fused Pallas kernel in interpret mode with ``fused_interpret=True``;
the port runs the plain versions of its kernels. Within the port, the
banded mesh is bitwise the single-device fused tier at any shard count,
fused or unfused, split or not; the halo plan reorders the neighbour slots
(the Morton remap), so it agrees with the gather tier to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

from conftest import make_synthetic
from flashdeconv_tpu import parallel as jpar
from flashdeconv_tpu.ops import bcd as jbcd
from flashdeconv_tpu.parallel import gspmd as jgspmd
from flashdeconv_tpu_torch import parallel as tpar
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.parallel import gspmd as tgspmd
from flashdeconv_tpu_torch.parallel import solver as tpsolver
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords
from torch_problems import BLOCK, as_torch, fused_problem

torch.set_num_threads(2)

SHARDS = [2, 4]
KW = dict(lambda_=0.3, rho=0.01, max_iter=60, tol=1e-4)


def cpu_mesh(n_shards):
    return ("cpu",) * n_shards


def sketch_problem(coords, n_types=7, d=48, seed=3, k=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n_types, d)
    Y = np.abs(rng.randn(coords.shape[0], n_types)) @ X \
        + 0.05 * rng.randn(coords.shape[0], d)
    return Y, X, build_knn_graph(coords, k=k)


def irregular(n=700, seed=1):
    return np.random.RandomState(seed).rand(n, 2) * np.sqrt(n)


def assert_matches_jax(port, ref):
    """Same sweeps, beta to 1e-5. The f32 objective subtracts terms about
    a hundred times its size (YtY - 2<beta, Xty> + ...), so it is held to
    1e-4 relative."""
    (tb, ti), (jb, ji) = port, ref
    assert ti["n_iterations"] == ji["n_iterations"]
    assert ti["converged"] == ji["converged"]
    np.testing.assert_allclose(tb, jb, atol=1e-5)
    np.testing.assert_allclose(ti["final_objective"], ji["final_objective"],
                               rtol=1e-4)


# -- the host plan -----------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("layout", ["grid", "irregular"])
def test_shard_plan_is_bitwise_jax(layout, n_shards):
    coords = grid_coords(side=30) if layout == "grid" else irregular()
    A = build_knn_graph(coords, k=6)
    np.testing.assert_array_equal(tpar.morton_order(coords),
                                  jpar.morton_order(coords))
    for kw in (dict(), dict(order="none"), dict(pad_shard_to=64,
                                                pad_deg_to=4)):
        got = tpar.plan_shards(A, n_shards, coords=coords, **kw)
        ref = jpar.plan_shards(A, n_shards, coords=coords, **kw)
        for field in ("n_spots", "n_shards", "shard_size", "halo_width"):
            assert getattr(got, field) == getattr(ref, field), field
        for field in ("perm", "nbr_idx", "n_nbrs", "send_idx", "spot_mask"):
            a, b = getattr(got, field), getattr(ref, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert tpar.halo_fraction(got) == jpar.halo_fraction(ref)


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_halo_exchange_reconstructs_the_neighbour_sums(n_shards):
    """The pooled boundary rows and the remapped tables give A @ beta on
    every shard (the JAX test_neighbor_sum_reconstruction, through the
    port's own exchange)."""
    coords = irregular(350, seed=7)
    A = build_knn_graph(coords, k=5)
    plan = tpar.plan_shards(A, n_shards, coords=coords)
    mesh = tpar.Mesh(cpu_mesh(n_shards))
    beta = np.random.RandomState(7).randn(350, 5)
    pad = plan.scatter(beta)
    S, hw = plan.shard_size, plan.halo_width
    betas = [torch.from_numpy(pad[s * S:(s + 1) * S].T.copy())
             for s in range(n_shards)]
    sends = [torch.from_numpy(plan.send_idx[s * hw:(s + 1) * hw]
                              .astype(np.int64)) for s in range(n_shards)]
    pools = tpsolver._halo_exchange(mesh, betas, sends)
    ns = np.concatenate([
        tpsolver._shard_ns(betas[s], pools[mesh[s]], torch.from_numpy(
            plan.nbr_idx[s * S:(s + 1) * S].T.astype(np.int64))).T.numpy()
        for s in range(n_shards)])
    np.testing.assert_allclose(plan.gather(ns), A @ beta, atol=1e-12)


# -- kernel #1's sub-range form -------------------------------------------------------

def _jax_sub(p, carry, lam, rho, sub, alias=None):
    inv = jbcd.gs_inv_den(jnp.asarray(p["XtX"]), jnp.asarray(p["nnb"]),
                          jnp.float32(lam))
    return jbcd.fused_banded_sweep(
        jnp.asarray(carry), jnp.asarray(p["Xty_t"]), jnp.asarray(p["XtX"]),
        jnp.asarray(p["masks"]), inv, jnp.float32(lam), jnp.float32(rho),
        p["offsets"], p["h"], block=BLOCK, sub=sub,
        out_alias=None if alias is None else jnp.asarray(alias),
        interpret=True,
    )


def _port_sub(p, carry, lam, rho, sub, out=None):
    tp = as_torch(p)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], lam)
    return tbcd.fused_banded_sweep(
        torch.from_numpy(carry), tp["Xty_t"], tp["XtX"], tp["masks"], inv,
        lam, rho, p["offsets"], p["h"], BLOCK, out=out, sub=sub)


def _close(got, ref):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=2e-5)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), atol=2e-5)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), atol=2e-5)


@pytest.mark.parametrize("K", [6, 20, 96])
def test_sub_range_sweep_matches_jax_interpret(K):
    """The interior and both boundary calls of a split sweep into a full
    carry (the JAX ``out_alias``, the port's ``out=``), whose other
    columns stay as they were; the interior call alone (a sub-carry with
    zero pads). The three calls into one carry recompose the whole sweep
    bit for bit, and each call alone holds its data columns. 64 x 64
    grids in 16 blocks; 32 x 32 in 4 at K = 96."""
    p = fused_problem(side=32 if K > 64 else 64, n_types=K, seed=K + 3)
    lam, rho = 0.5, 0.1
    h, m = p["h"], p["Xty_t"].shape[1] // BLOCK
    pad = h * BLOCK
    interior = (h, h, m - 2 * h)
    _close(_port_sub(p, p["carry"], lam, rho, interior),
           _jax_sub(p, p["carry"], lam, rho, interior))
    whole = _port_sub(p, p["carry"], lam, rho, None)
    full = torch.full(p["carry"].shape, 7.0)
    for sub in (interior, (0, 0, h), (m - h, m - h, h)):
        ref = _jax_sub(p, p["carry"], lam, rho, sub,
                       alias=np.full(p["carry"].shape, 7.0, np.float32))
        got = _port_sub(p, p["carry"], lam, rho, sub,
                        out=torch.full(p["carry"].shape, 7.0))
        _close(got, ref)
        assert _port_sub(p, p["carry"], lam, rho, sub, out=full)[0] is full
        alone = _port_sub(p, p["carry"], lam, rho, sub)[0]
        assert alone.shape == (K, (sub[2] + 2 * h) * BLOCK)
        cols = slice(pad + sub[1] * BLOCK, pad + (sub[1] + sub[2]) * BLOCK)
        assert torch.equal(alone[:, pad:-pad], full[:, cols])
        assert (alone[:, :pad] == 0).all() and (alone[:, -pad:] == 0).all()
    assert torch.equal(full[:, pad:-pad], whole[0][:, pad:-pad])
    assert (full[:, :pad] == 7.0).all() and (full[:, -pad:] == 7.0).all()


def test_sub_range_reads_an_assembled_window_as_jax_does():
    """The JAX split's boundary calls read a small ``[halo | edge data]``
    buffer (carry_start 0, data_start m - h): the port takes the same
    call and writes the same columns as on the full carry."""
    p = fused_problem(side=64, n_types=20, seed=9)
    lam, rho = 0.5, 0.1
    h, m = p["h"], p["Xty_t"].shape[1] // BLOCK
    side = np.ascontiguousarray(p["carry"][:, (m - h) * BLOCK:])
    sub = (0, m - h, h)
    alias = np.full(p["carry"].shape, 7.0, np.float32)
    ref = _jax_sub(p, side, lam, rho, sub, alias=alias)
    got = _port_sub(p, side, lam, rho, sub, out=torch.from_numpy(alias))
    _close(got, ref)
    on_full = _port_sub(p, p["carry"], lam, rho, (m - h, m - h, h),
                        out=torch.full(p["carry"].shape, 7.0))
    assert torch.equal(got[0], on_full[0])


def test_sub_range_off_the_carry_or_the_data_raises():
    p = fused_problem(side=64, n_types=6)
    m = p["Xty_t"].shape[1] // BLOCK
    for sub, match in (((1, 0, m), "leaves the carry"),
                       ((0, 1, m), "leave the"), ((0, 0, 0), "at least")):
        with pytest.raises(ValueError, match=match):
            _port_sub(p, p["carry"], 0.5, 0.1, sub)


# -- the solves against the JAX package -----------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_halo_solve_matches_jax(n_shards):
    coords = irregular()
    Y, X, A = sketch_problem(coords)
    ref = jpar.sharded_bcd_solve(Y, X, A, coords=coords, n_shards=n_shards,
                                 strategy="halo", **KW)
    got = tpar.sharded_bcd_solve(Y, X, A, coords=coords,
                                 mesh=cpu_mesh(n_shards), strategy="halo",
                                 device="cpu", **KW)
    assert_matches_jax(got, ref)
    for key in ("n_shards", "halo_width"):
        assert got[1][key] == ref[1][key], key


@pytest.mark.parametrize("n_shards", SHARDS)
def test_halo_solve_matches_the_gather_tier(n_shards):
    """The same sweeps as the single-device gather tier; beta to 1e-5 (the
    Morton remap reorders the neighbour slots, so not bitwise)."""
    coords = irregular(900, seed=4)
    Y, X, A = sketch_problem(coords, seed=4)
    ref, info = tsolver.bcd_solve(Y, X, A, coords=coords, device="cpu", **KW)
    beta, sh = tpar.sharded_bcd_solve(Y, X, A, coords=coords,
                                      mesh=cpu_mesh(n_shards),
                                      strategy="halo", device="cpu", **KW)
    assert sh["n_iterations"] == info["n_iterations"]
    np.testing.assert_allclose(beta, ref, atol=1e-5)


def _grid(side=64, seed=5, n_types=7):
    coords = grid_coords(side=side)
    return (*sketch_problem(coords, n_types=n_types, seed=seed), coords)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_fused_banded_mesh_matches_jax_interpret(n_shards):
    """The fused gate on both sides (blocks of 256, h = 1; JAX's Pallas
    kernel in interpret mode): JAX's solve (its "auto" splits these
    shards) against the port's solve and its loop with the overlap split
    forced on and off."""
    Y, X, A, _ = _grid()
    kw = dict(KW, max_iter=30)
    jmesh = jpar.default_mesh(n_shards)
    jp = jgspmd.GspmdBandedProblem(Y, X, A, mesh=jmesh, fused_block=BLOCK,
                                   fused_interpret=True)
    assert jp.use_fused
    ref = jp.solve(**kw)
    tp = tgspmd.GspmdBandedProblem(Y, X, A, mesh=cpu_mesh(n_shards),
                                   fused_block=BLOCK, device="cpu")
    assert tp.use_fused and tp._fused_h == jp._fused_h == 1
    got = tp.solve(**kw)
    assert_matches_jax(got, ref)
    assert got[1]["fused_kernel"] and got[1]["n_bands"] == ref[1]["n_bands"]
    for overlap in (False, True):
        beta, it, _ = tp._run(kw["lambda_"], kw["rho"], kw["tol"],
                              kw["max_iter"], overlap=overlap)
        assert it == ref[1]["n_iterations"]
        np.testing.assert_array_equal(beta.double().numpy(), got[0])


@pytest.mark.parametrize("n_shards", SHARDS)
def test_unfused_banded_mesh_matches_jax(n_shards):
    """A halo wider than FUSED_MAX_H blocks (blocks of one spot) takes the
    port's unfused loop: banded sums in plain torch and kernel #2 per
    shard; JAX's CPU mesh runs its unfused XLA loop."""
    Y, X, A, _ = _grid(side=40, seed=6)
    ref = jpar.gspmd_banded_solve(Y, X, A, mesh=jpar.default_mesh(n_shards),
                                  **KW)
    tp = tgspmd.GspmdBandedProblem(Y, X, A, mesh=cpu_mesh(n_shards),
                                   fused_block=1, device="cpu")
    assert not tp.use_fused
    got = tp.solve(**KW)
    assert_matches_jax(got, ref)
    assert not got[1]["fused_kernel"]
    for key in ("n_shards", "n_bands", "halo_width"):
        assert got[1][key] == ref[1][key], key


@pytest.mark.parametrize("K", [20, 96])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_banded_mesh_is_bitwise_the_fused_tier(n_shards, K):
    """A 96 x 96 grid (the fused tier's size): the mesh, fused with blocks
    of 256 (split and unsplit) and unfused, gives the single-device fused
    tier's sweeps and beta bit for bit."""
    Y, X, A, coords = _grid(side=96, seed=K, n_types=K)
    kw = dict(lambda_=0.3, rho=0.01, tol=1e-4, max_iter=40)
    single = tsolver.prepare_bcd(Y, X, A, coords=coords, device="cpu")
    assert single.use_fused_banded
    ref, info = single.solve(**kw)
    fused = tgspmd.GspmdBandedProblem(Y, X, A, mesh=cpu_mesh(n_shards),
                                      fused_block=BLOCK, device="cpu")
    assert fused.use_fused and fused.n_local // BLOCK >= 3
    for overlap in (False, True):
        beta, it, _ = fused._run(kw["lambda_"], kw["rho"], kw["tol"],
                                 kw["max_iter"], overlap=overlap)
        assert it == info["n_iterations"]
        np.testing.assert_array_equal(beta.double().numpy(), ref)
    unfused = tgspmd.GspmdBandedProblem(Y, X, A, mesh=cpu_mesh(n_shards),
                                        fused_block=1, device="cpu")
    assert not unfused.use_fused
    beta, sh = unfused.solve(**kw)
    assert sh["n_iterations"] == info["n_iterations"]
    np.testing.assert_array_equal(beta, ref)


def test_scrambled_grid_resort_dispatch_matches_jax():
    """A shuffled grid at >= RESORT_MIN_SPOTS spots is re-sorted into a
    banded one (the same permutation as JAX's) and solved on the banded
    mesh; below that size both packages take the halo plan."""
    coords = grid_coords(side=96)
    coords = coords[np.random.RandomState(0).permutation(coords.shape[0])]
    Y, X, A = sketch_problem(coords, seed=8)
    assert coords.shape[0] >= tpsolver.RESORT_MIN_SPOTS
    jp = jpar.prepare_sharded_bcd(Y, X, A, coords=coords, n_shards=2)
    tp = tpar.prepare_sharded_bcd(Y, X, A, coords=coords, mesh=cpu_mesh(2),
                                  device="cpu")
    assert tp.strategy == jp.strategy == "banded"
    np.testing.assert_array_equal(tp._perm, jp._perm)
    assert_matches_jax(tp.solve(**KW), jp.solve(**KW))

    small = coords[coords.max(axis=1) < 40]
    Ys, Xs, As = sketch_problem(small, seed=8)
    for pkg, kw in ((jpar, dict(n_shards=2)),
                    (tpar, dict(mesh=cpu_mesh(2), device="cpu"))):
        assert pkg.prepare_sharded_bcd(Ys, Xs, As, coords=small,
                                       **kw).strategy == "halo"


def test_beta_init_and_verbose_match_jax(capsys):
    """A warm start (in the original spot order, through the re-sort-free
    halo plan) and the verbose cadence: the objectives after sweeps 1, 11,
    21, ... and at convergence, as the JAX package records them."""
    coords = irregular(600, seed=2)
    Y, X, A = sketch_problem(coords, seed=2)
    init = np.abs(np.random.RandomState(2).randn(600, 7))
    runs = {}
    for name, pkg, kw in (("jax", jpar, dict(n_shards=2)),
                          ("port", tpar, dict(mesh=cpu_mesh(2),
                                              device="cpu"))):
        runs[name] = pkg.sharded_bcd_solve(
            Y, X, A, coords=coords, strategy="halo", verbose=True,
            beta_init=init, **dict(KW, tol=1e-6), **kw)
    assert_matches_jax(runs["port"], runs["jax"])
    np.testing.assert_allclose(runs["port"][1]["objectives"],
                               runs["jax"][1]["objectives"], rtol=1e-4)
    assert "Iteration 0: objective" in capsys.readouterr().out
    with pytest.raises(ValueError, match="beta_init shape"):
        tpar.sharded_bcd_solve(Y, X, A, coords=coords, mesh=cpu_mesh(2),
                               device="cpu", beta_init=init[:5])


def test_degenerate_inputs_keep_the_info_contract():
    empty = sparse.csr_matrix((10, 10))
    coords = grid_coords(side=5)
    A = build_knn_graph(coords, k=3)
    rng = np.random.RandomState(0)
    Y, X = rng.rand(25, 8), rng.rand(3, 8)
    cases = [
        (tpar.sharded_bcd_solve, jpar.sharded_bcd_solve,
         (np.zeros((10, 8)), np.zeros((0, 8)), empty), {}),
        (tpar.sharded_bcd_solve, jpar.sharded_bcd_solve, (Y, X, A),
         dict(max_iter=0)),
        (tpar.gspmd_banded_solve, jpar.gspmd_banded_solve, (Y, X, A),
         dict(max_iter=0)),
    ]
    for port_fn, jax_fn, args, kw in cases:
        tb, ti = port_fn(*args, mesh=cpu_mesh(2), device="cpu", **kw)
        jb, ji = jax_fn(*args, mesh=jpar.default_mesh(2), **kw)
        assert ti == ji
        assert tb.shape == jb.shape
        np.testing.assert_array_equal(tb, jb)
    with pytest.raises(ValueError, match="non-empty"):
        tpar.prepare_sharded_bcd(np.zeros((10, 8)), np.zeros((0, 8)), empty,
                                 mesh=cpu_mesh(2))
    with pytest.raises(ValueError, match="not fully banded"):
        tpar.gspmd_banded_solve(Y, X, build_knn_graph(irregular(25), k=6),
                                mesh=cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="ShardPlan"):
        tpar.sharded_bcd_solve(Y, X, A, mesh=cpu_mesh(2), device="cpu",
                               strategy="banded",
                               plan=tpar.plan_shards(A, 2))


# -- the mesh ------------------------------------------------------------------------

def test_default_mesh_and_mesh():
    mesh = tpar.default_mesh(4, device="cpu")
    assert len(mesh) == 4 and all(d.type == "cpu" for d in mesh)
    assert len(tpar.default_mesh(device="cpu")) == 1
    with pytest.raises(ValueError, match=">= 1"):
        tpar.default_mesh(0, device="cpu")
    # Past the visible cards (none here): it raises, never runs on the CPU.
    with pytest.raises((RuntimeError, ValueError)):
        tpar.default_mesh(torch.cuda.device_count() + 1, device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tpar.Mesh(("cuda:0",) * 2)
    with pytest.raises(ValueError, match="at least one"):
        tpar.Mesh(())
    stats = [torch.tensor(1.0), torch.tensor(float("nan")),
             torch.tensor(2.0), torch.tensor(3.0)]
    d, a = tpar.Mesh(cpu_mesh(2)).join_max(stats)
    assert float(d) == 2.0 and torch.isnan(a)


def test_exports_match_the_jax_package():
    """The JAX package's names without ``multihost``, plus ``Mesh``."""
    assert set(tpar.__all__) == (set(jpar.__all__) - {"multihost"}) | {"Mesh"}


# -- FlashDeconv(mesh=..., n_shards=...) ------------------------------------------------

@pytest.fixture(scope="module")
def sharded_fits():
    import flashdeconv_tpu
    import flashdeconv_tpu_torch

    out = {}
    for layout, grid in (("grid", True), ("irregular", False)):
        Y, X, coords, truth = make_synthetic(
            n_spots=900, n_genes=400, n_types=6, seed=3, grid=grid,
            sparse_output=True)
        kw = dict(sketch_dim=128, n_hvg=300, n_markers_per_type=10)
        ref = flashdeconv_tpu.FlashDeconv(n_shards=2, **kw)
        ref.fit(Y, X, coords)
        port = flashdeconv_tpu_torch.FlashDeconv(device="cpu", n_shards=2,
                                                 **kw)
        port.fit(Y, X, coords)
        meshed = flashdeconv_tpu_torch.FlashDeconv(device="cpu",
                                                   mesh=cpu_mesh(2), **kw)
        meshed.fit(Y, X, coords)
        out[layout] = (ref, port, meshed, truth)
    return out


@pytest.mark.parametrize("layout", ["grid", "irregular"])
def test_sharded_fit_matches_jax(sharded_fits, layout):
    ref, port, meshed, truth = sharded_fits[layout]
    assert port.lambda_used_ == ref.lambda_used_
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    assert port.info_["n_shards"] == ref.info_["n_shards"] == 2
    np.testing.assert_allclose(port.proportions_, ref.proportions_,
                               atol=1e-4)
    np.testing.assert_array_equal(meshed.proportions_, port.proportions_)
    corr = np.corrcoef(port.proportions_.ravel(), truth.ravel())[0, 1]
    assert corr > 0.5


def test_flashdeconv_rejects_bad_shard_counts():
    import flashdeconv_tpu_torch

    with pytest.raises(ValueError, match="n_shards must be >= 1"):
        flashdeconv_tpu_torch.FlashDeconv(device="cpu", n_shards=0)
    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu", n_shards=1)
    assert not model._is_sharded
    assert flashdeconv_tpu_torch.FlashDeconv(device="cpu",
                                             mesh=cpu_mesh(1))._is_sharded
