"""The CUDA kernels against their plain PyTorch versions, and against each
other.

Runs only where there is a card (marker ``cuda``; ``python -m pytest
--noconftest -m cuda tests/test_torch_kernels.py`` on a machine without
JAX): the kernels have no CPU mode. The card is looked for inside a
fixture, so every pytest worker collects the same tests. Bounds against
the plain versions: atol 5e-5 / rtol 1e-4 on beta and rtol 1e-4 on the
statistics — the kernels contract multiply-adds into FMAs and sum the
XtX @ beta product in their own order, so they are not bitwise equal to
them. The two kernels run one Gauss-Seidel device function (the register
pass at K <= 32, the panel pass of 16 coordinates at 32 < K <= 384), so
the fused and unfused banded sweeps are bitwise equal to each other, and
two launches on the same operands are bitwise equal. The
CountSketch kernel is held to 2e-5 * max(max|ref|, 1) against its plain
version and an f64 projection (the JAX package's CountSketch bound), and
bitwise against itself. Kernel #1's sub-range form is held against its
plain version, and a split sweep bitwise against the whole one; the banded
mesh with several shards on one card bitwise against the single-device
fused tier, and the halo plan within 1e-5 of the gather tier. Kernel #1
with the rest stream's ``ns_rest`` input is held against its plain
version, and the fused tier with the rest stream bitwise against the
unfused banded tier with the same rest table. Kernel #1's spot-panel pass
(32 < K <= 64) is held bitwise against kernel #2's tile pass on the
banded sums at K = 34, 47 and 48: whole, with ``ns_rest`` and split, and
so is the tile pass's one-block range (256 < K <= 384, K = 257, 300, 338
and 384 and 288 and 352, kernel #1's WIDE form), each launch counted on
``.wide_launches``, and on grids whose last block of 64 columns is ragged.
The
fetch of a card tensor
to the host (``fetch_to_host``, through pinned staging buffers) is held
bit for bit against ``tensor.cpu()``, ``return_device`` against the host
solve, and the streamed Xty feed against the host cast. The fused tier's
objective kernel is held within rtol 1e-5 of the plain path on the card
(with and without the rest stream), each of its five sums within
``OBJECTIVE_SUM_RTOL``, and bitwise against itself, at K <= 32 and in
the panel pass's range (33 <= K <= 56, its large-K form); a whole
fused-tier solve launches it once at K <= 56 and never at K = 57. The
gather tier's neighbour-sum kernel is held bit for bit against the plain
loop at the benchmark's tissue shape (417,768 spots, D = 10) at K = 20
and 96, and a gather-tier solve through it bit for bit against the same
solve on the plain loop, with one launch a sweep and one for the
objective; a fused-tier solve launches none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.utils.graph import (
    adjacency_to_padded,
    build_knn_graph,
    grid_coords,
)
from torch_problems import (
    as_torch,
    dropped_grid_coords,
    fused_problem,
    gather_problem,
    with_rest,
)

pytestmark = pytest.mark.cuda


# The register pass at K = 6, 20, 24 (KMAX = K) and 32 (its last K); the
# panel pass from K = 33 (kernel #1's spot-panel pass to K = 64, the tile
# pass above; kernel #2's tile pass throughout): whole panels (48, 64, 80,
# 96, 128, 256, 384) and a ragged last panel and register tile (33, 34, 65,
# 129, 255, 257, 288, 300, 338, 352), of 13 to 15 rows at 45, 47, 61 and
# 63; above K = 256 the tile pass's one-block instances (TM = 9 to 12,
# kernel #1's WIDE form).
WIDE_KS = [257, 288, 300, 338, 352, tbcd.KERNEL_MAX_K]
KS = [6, 20, 24, 32, 33, 34, 45, 47, 48, 61, 63, 64, 65, 80, 96, 128, 129,
      255, 256] + WIDE_KS
# Each sum of the objective kernel against the plain path's on the card.
OBJECTIVE_SUM_RTOL = 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _launches(wrapper, K):
    """The count of the kernel ``wrapper`` launches at K: its register
    form at K <= ``REGISTER_PASS_MAX_K`` (32), its panel form above."""
    if K > tbcd.REGISTER_PASS_MAX_K:
        return wrapper.large_k_launches
    return wrapper.launches


@pytest.mark.parametrize("K", KS)
def test_kernel_matches_plain_version(cuda_device, K):
    p = fused_problem(n_types=K, seed=K)
    tp = as_torch(p, cuda_device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    before = _launches(tbcd.fused_banded_sweep, K)
    spot = tbcd.fused_banded_sweep.spot_panel_launches
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.fused_banded_sweep_reference(*args)
        out = torch.full_like(tp["carry"], float("nan"))
        got, d, a = tbcd.fused_banded_sweep(*args, out=out)
    torch.cuda.synchronize()
    assert _launches(tbcd.fused_banded_sweep, K) == before + 1
    assert tbcd.fused_banded_sweep.spot_panel_launches == spot + (
        tbcd.REGISTER_PASS_MAX_K < K <= tbcd.SPOT_PANEL_MAX_K)
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
    pad = p["h"] * p["block"]
    assert (got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("K", [20, 34, 96])
@pytest.mark.parametrize("where", ["XtX", "inv_den", "lambda"])
def test_kernel_propagates_nan_like_plain_version(cuda_device, where, K):
    """A NaN operand gives NaN in the same places as the plain version
    and a NaN max_diff, so the sweep cannot pass for converged."""
    p = fused_problem(n_types=K, seed=1)
    tp = as_torch(p, cuda_device)
    lam = float("nan") if where == "lambda" else 0.5
    if where == "XtX":
        tp["XtX"][10, 1] = float("nan")
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], lam).contiguous()
    if where == "inv_den":
        inv[7, 300] = float("nan")
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, lam, 0.1,
            p["offsets"], p["h"], p["block"])
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.fused_banded_sweep_reference(*args)
        got, d, a = tbcd.fused_banded_sweep(*args)
    torch.cuda.synchronize()
    assert torch.isnan(ref).any()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4, equal_nan=True)
    assert torch.isnan(d) and torch.isnan(rd)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)


def test_kernel_solve_matches_plain_solve(cuda_device):
    """Ten sweeps through the ping-pong loop on the card."""
    p = fused_problem(n_types=20, seed=3)
    tp = as_torch(p, cuda_device)
    args = (tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"], 0.5, 0.05,
            1e-30, 10, p["offsets"], p["h"], p["block"])
    got, it, _ = tbcd.bcd_iterate_banded_fused(tp["carry"].clone(), *args)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5)
    ref = tp["carry"].clone()
    with tbcd.full_f32_matmul():
        for _ in range(10):
            ref, _, _ = tbcd.fused_banded_sweep_reference(
                ref, tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.05,
                p["offsets"], p["h"], p["block"],
            )
    assert it == 10
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)


def _rest_args(K, device, seed):
    """A 64 x 64 grid (32 x 32 above K = 64) with 200 random rest edges, its
    refreshed ``ns_rest`` and the sweep's arguments."""
    p = with_rest(fused_problem(side=32 if K > 64 else 64, n_types=K,
                                seed=seed), seed=seed)
    tp = as_torch(p, device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    nsr = tbcd.rest_ns_update(torch.zeros_like(tp["Xty_t"]), tp["carry"],
                              tp["touched"], tp["slot_cols"])
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    return p, tp, args, nsr


@pytest.mark.parametrize("K", KS)
def test_kernel_with_rest_matches_plain_version(cuda_device, K):
    """One launch with ``ns_rest``, counted on ``.rest_launches`` only;
    a CPU ``ns_rest`` beside a CUDA carry raises, launching nothing."""
    p, tp, args, nsr = _rest_args(K, cuda_device, seed=K + 21)
    counts = ("launches", "large_k_launches", "sub_launches", "rest_launches")
    before = [getattr(tbcd.fused_banded_sweep, c) for c in counts]
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.fused_banded_sweep_reference(*args, ns_rest_t=nsr)
        out = torch.full_like(tp["carry"], float("nan"))
        got, d, a = tbcd.fused_banded_sweep(*args, out=out, ns_rest_t=nsr)
    torch.cuda.synchronize()
    after = [getattr(tbcd.fused_banded_sweep, c) for c in counts]
    assert [x - y for x, y in zip(after, before)] == [0, 0, 0, 1]
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
    pad = p["h"] * p["block"]
    assert (got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()
    with pytest.raises(ValueError, match="ns_rest_t is on cpu"):
        tbcd.fused_banded_sweep(*args, ns_rest_t=nsr.cpu())
    assert tbcd.fused_banded_sweep.rest_launches == after[3]


@pytest.mark.parametrize("K", KS)
def test_fused_rest_and_unfused_banded_are_bitwise_equal(cuda_device, K):
    """Ten sweeps through the rest stream and the fused kernel, and through
    the unfused banded sums with the same rest table and the
    coordinate-descent kernel: the same bits."""
    p, tp, _, _ = _rest_args(K, cuda_device, seed=K + 23)
    n, pad = p["Xty_t"].shape[1], p["h"] * p["block"]
    args = (0.5, 0.05, 1e-30, 10)
    before = (tbcd.fused_banded_sweep.rest_launches,
              _launches(tbcd.coordinate_descent_block, K))
    carry, it_f, rel_f = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"],
        *args, p["offsets"], p["h"], p["block"],
        rest_touched=tp["touched"], rest_slot_cols=tp["slot_cols"],
    )
    beta_t, it_u, rel_u = tbcd.bcd_iterate_banded(
        tp["carry"][:, pad:pad + n].contiguous(), tp["Xty_t"], tp["XtX"],
        p["offsets"], tp["masks"].float(), tp["rest_t"], tp["nnb"], *args,
    )
    torch.cuda.synchronize()
    assert (tbcd.fused_banded_sweep.rest_launches - before[0],
            _launches(tbcd.coordinate_descent_block, K) - before[1]
            ) == (10, 10)
    assert it_f == it_u == 10 and rel_f == rel_u
    assert torch.equal(tbcd.from_fused_carry(carry, p["h"], p["block"]).T,
                       beta_t)


def test_dropped_grid_solves_on_the_rest_stream(cuda_device):
    """A 128 x 128 grid with 5 % of its bins dropped takes the fused tier
    with rest tables; its solve is bitwise the unfused banded tier's and
    launches the kernel with ``ns_rest`` once a sweep."""
    coords = dropped_grid_coords(128, 0.05)
    rng = np.random.RandomState(2)
    X = rng.randn(20, 48)
    Y = np.abs(rng.randn(coords.shape[0], 20)) @ X \
        + 0.05 * rng.randn(coords.shape[0], 48)
    prob = tsolver.prepare_bcd(Y, X, build_knn_graph(coords, k=6),
                               coords=coords, device=cuda_device)
    t = prob.tier
    assert prob.use_fused_banded and t.rest_touched is not None
    before = (tbcd.fused_banded_sweep.launches,
              tbcd.fused_banded_sweep.rest_launches)
    beta, info = prob.solve()
    assert info["converged"]
    assert (tbcd.fused_banded_sweep.launches - before[0],
            tbcd.fused_banded_sweep.rest_launches - before[1]
            ) == (0, info["n_iterations"])
    lam, rho = tbcd.f32(0.1), tbcd.f32(0.01 * prob.mean_diag)
    runs = [tbcd.fused_solve(None, tier, None, lam, rho, 1e-4, 100,
                             prob.n_spots) for tier in (t, t.unfused())]
    assert runs[0][1] == runs[1][1] == info["n_iterations"]
    assert torch.equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][0].double().cpu().numpy(), beta)


def _objective_launches():
    return (tbcd.fused_banded_objective.launches
            + tbcd.fused_banded_objective.large_k_launches)


@pytest.mark.parametrize("rest", [False, True])
@pytest.mark.parametrize("K", [6, 20, 32, 33, 34, 48, 56])
def test_objective_kernel_matches_plain_path(cuda_device, K, rest):
    """The fused tier's objective on a CUDA f32 carry at K <= 56 launches
    the objective kernel once (with the rest sums as its ``ns_rest`` input
    when the tier has rest tables): within rtol 1e-5 of the plain path on
    the same card, and two launches bitwise equal. Each of its five sums
    (cross, degree, adjacency, L1, quad) within ``OBJECTIVE_SUM_RTOL`` of
    the plain path's on the card."""
    p = fused_problem(n_types=K, seed=K + 31)
    if rest:
        p = with_rest(p, seed=K + 31)
    tp = as_torch(p, cuda_device)
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], 5e4, p["offsets"],
            tp["masks"], 0.5, 0.1, p["h"], p["block"])
    kw = dict(nnb=tp["nnb"])
    if rest:
        kw.update(rest_touched=tp["touched"], rest_slot_cols=tp["slot_cols"])
    nsr = tbcd.rest_ns_update(torch.zeros_like(tp["Xty_t"]), tp["carry"],
                              tp["touched"], tp["slot_cols"]) if rest else None
    before = _objective_launches()
    large = tbcd.fused_banded_objective.large_k_launches
    with tbcd.full_f32_matmul():
        ref = tbcd.objective_terms_banded_fused_reference(*args, **kw)
        got = tbcd.objective_terms_banded_fused(*args, **kw)
        again = tbcd.objective_terms_banded_fused(*args, **kw)
        sums = tbcd.fused_banded_objective_sums(
            tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"],
            tp["nnb"].reshape(-1), p["offsets"], p["h"], p["block"], nsr)
        ref_sums = tbcd.fused_banded_objective_sums_reference(
            tp["carry"], tp["Xty_t"], tp["XtX"], p["offsets"], tp["masks"],
            p["h"], p["block"], tp["nnb"], kw.get("rest_touched"),
            kw.get("rest_slot_cols"))
    assert _objective_launches() == before + 3
    assert tbcd.fused_banded_objective.large_k_launches == large + (
        3 if K > tbcd.REGISTER_PASS_MAX_K else 0)
    assert got.dtype == ref.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    assert torch.equal(got, again)
    np.testing.assert_allclose(sums.numpy(), ref_sums.cpu().numpy(),
                               rtol=OBJECTIVE_SUM_RTOL)


def _grid_problem(K, side=128, seed=4):
    """A side x side grid kNN-6 problem at K prepared on the card: the
    fused tier."""
    coords = grid_coords(side=side)
    rng = np.random.RandomState(seed)
    X = rng.randn(K, K + 28)
    Y = np.abs(rng.randn(coords.shape[0], K)) @ X \
        + 0.05 * rng.randn(coords.shape[0], K + 28)
    prob = tsolver.prepare_bcd(Y, X, build_knn_graph(coords, k=6),
                               coords=coords, device="cuda")
    assert prob.use_fused_banded
    return prob


@pytest.mark.parametrize("K", [20, 48, 57])
def test_fused_solve_objective_route(cuda_device, K, monkeypatch):
    """A whole ``BCDProblem.solve`` on the fused tier. At K = 20 and 48 it
    launches the objective kernel exactly once, and its final objective
    lies within rtol 1e-5 of the same solve's with the plain path; at
    K = 57 it launches none and gives the plain path's objective bit for
    bit. Beta and the sweep count are bitwise those of the plain path's
    solve."""
    prob = _grid_problem(K)
    before = _objective_launches()
    beta, info = prob.solve()
    launched = _objective_launches() - before
    monkeypatch.setattr(tbcd, "objective_terms_banded_fused",
                        tbcd.objective_terms_banded_fused_reference)
    beta_p, info_p = prob.solve()
    assert _objective_launches() == before + launched
    assert launched == (1 if K <= tbcd.OBJECTIVE_KERNEL_MAX_K else 0)
    np.testing.assert_array_equal(beta, beta_p)
    assert info["n_iterations"] == info_p["n_iterations"]
    if launched:
        np.testing.assert_allclose(info["final_objective"],
                                   info_p["final_objective"], rtol=1e-5)
    else:
        assert info["final_objective"] == info_p["final_objective"]


def _cd_args(p, lam=0.5, rho=0.1):
    tp = {k: torch.from_numpy(v).cuda() for k, v in p.items()
          if k != "coords"}
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(tp["beta_t"]), tp["nbr_t"])
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], lam).contiguous()
    return tp, [tp["beta_t"], tp["Xty_t"], tp["XtX"], ns, inv, lam, rho]


@pytest.mark.parametrize("K", KS)
def test_cd_kernel_matches_plain_version(cuda_device, K):
    """3,000 spots: a ragged tail after 11 full blocks of 256 (K <= 64) or
    46 full blocks of 64 (above)."""
    _, args = _cd_args(gather_problem(n_types=K, seed=K))
    before = _launches(tbcd.coordinate_descent_block, K)
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.coordinate_descent_block_reference(*args)
        out = torch.full_like(args[0], float("nan"))
        got, d, a = tbcd.coordinate_descent_block(*args, out=out)
    torch.cuda.synchronize()
    assert _launches(tbcd.coordinate_descent_block, K) == before + 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
    assert (got >= 0).all()


@pytest.mark.parametrize("K", [20, 96])
@pytest.mark.parametrize("where", ["XtX", "inv_den", "lambda"])
def test_cd_kernel_propagates_nan_like_plain_version(cuda_device, where, K):
    tp, args = _cd_args(gather_problem(n_types=K, seed=1),
                        lam=float("nan") if where == "lambda" else 0.5)
    if where == "XtX":
        args[2][10, 1] = float("nan")
    if where == "inv_den":
        args[4][7, 300] = float("nan")
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.coordinate_descent_block_reference(*args)
        got, d, a = tbcd.coordinate_descent_block(*args)
    torch.cuda.synchronize()
    assert torch.isnan(ref).any()
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4, equal_nan=True)
    assert torch.isnan(d) and torch.isnan(rd)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)


@pytest.mark.parametrize("K", KS)
def test_fused_and_unfused_banded_kernels_are_bitwise_equal(cuda_device, K):
    """Ten sweeps of the same grid operands through the fused kernel and
    through the banded neighbour sums plus the coordinate-descent kernel."""
    p = fused_problem(n_types=K, seed=K + 2)
    tp = as_torch(p, cuda_device)
    n = p["Xty_t"].shape[1]
    pad = p["h"] * p["block"]
    args = (0.5, 0.05, 1e-30, 10)
    before = (_launches(tbcd.fused_banded_sweep, K),
              _launches(tbcd.coordinate_descent_block, K))
    carry, it_f, rel_f = tbcd.bcd_iterate_banded_fused(
        tp["carry"].clone(), tp["Xty_t"], tp["XtX"], tp["masks"], tp["nnb"],
        *args, p["offsets"], p["h"], p["block"],
    )
    beta_t, it_u, rel_u = tbcd.bcd_iterate_banded(
        tp["carry"][:, pad:pad + n].contiguous(), tp["Xty_t"], tp["XtX"],
        p["offsets"], tp["masks"].float(),
        torch.zeros((0, n), dtype=torch.int32, device=cuda_device),
        tp["nnb"], *args,
    )
    torch.cuda.synchronize()
    assert (_launches(tbcd.fused_banded_sweep, K) - before[0],
            _launches(tbcd.coordinate_descent_block, K) - before[1]
            ) == (10, 10)
    assert it_f == it_u == 10 and rel_f == rel_u
    assert torch.equal(tbcd.from_fused_carry(carry, p["h"], p["block"]).T,
                       beta_t)


@pytest.mark.parametrize("K", [34, 65, 80, 96, 128, 129, 255, 256])
def test_two_launches_are_bitwise_equal(cuda_device, K):
    """Each kernel twice on the same operands: the same bits (no atomics,
    one summation order)."""
    p = fused_problem(n_types=K, seed=K + 5)
    tp = as_torch(p, cuda_device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    fused = [tbcd.fused_banded_sweep(*args) for _ in range(2)]
    _, cd_args = _cd_args(gather_problem(n_types=K, seed=K + 5))
    cd = [tbcd.coordinate_descent_block(*cd_args) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in (fused, cd):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gather_solve_is_bitwise_repeatable(cuda_device):
    """Two solves of one prepared gather-tier problem, with overflow hubs
    (a binding degree cap), give the same beta bit for bit."""
    p = gather_problem(n=5000, n_types=12, seed=4)
    rng = np.random.RandomState(5)
    X = rng.randn(12, 48)
    Y = np.abs(rng.randn(5000, 12)) @ X + 0.05 * rng.randn(5000, 48)
    A = build_knn_graph(p["coords"], k=6)
    prob = tsolver.prepare_bcd(Y, X, A, coords=p["coords"], max_degree=6,
                               device=cuda_device)
    assert type(prob.tier).__name__ == "GatherTier"
    assert prob.tier.overflow is not None
    beta_a, info_a = prob.solve()
    beta_b, info_b = prob.solve()
    assert info_a["converged"] and info_a == info_b
    np.testing.assert_array_equal(beta_a, beta_b)


# -- kernel #1's sub-range form (the banded mesh's overlap split) -------------------

def _split_args(K, device, seed=0):
    """A 64 x 64 grid in 16 blocks of 256 spots, h = 1, and the three
    sub-ranges of a split sweep: the interior and both boundaries."""
    p = fused_problem(n_types=K, seed=seed)
    tp = as_torch(p, device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    h, m = p["h"], p["Xty_t"].shape[1] // p["block"]
    return args, h * p["block"], ((h, h, m - 2 * h), (0, 0, h),
                                  (m - h, m - h, h))


@pytest.mark.parametrize("K", KS)
def test_sub_range_kernel_matches_plain_version(cuda_device, K):
    """Each sub-call alone (a sub-carry with zero pads) and into a full
    carry (its data columns only) against the plain version."""
    args, pad, subs = _split_args(K, cuda_device, seed=K + 11)
    before = tbcd.fused_banded_sweep.sub_launches
    with tbcd.full_f32_matmul():
        for sub in subs:
            ref, rd, ra = tbcd.fused_banded_sweep_reference(*args, sub=sub)
            got, d, a = tbcd.fused_banded_sweep(*args, sub=sub)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
            torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
            torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
            assert (got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()
            full = torch.full_like(args[0], float("nan"))
            ref_full = full.clone()
            tbcd.fused_banded_sweep_reference(*args, out=ref_full, sub=sub)
            tbcd.fused_banded_sweep(*args, out=full, sub=sub)
            torch.cuda.synchronize()
            torch.testing.assert_close(full, ref_full, atol=5e-5, rtol=1e-4,
                                       equal_nan=True)
            assert torch.equal(torch.isnan(full), torch.isnan(ref_full))
    assert tbcd.fused_banded_sweep.sub_launches == before + 2 * len(subs)


@pytest.mark.parametrize("K", [6, 20, 34, 48, 64, 65, 80, 128, 129, 255,
                               256, 338, 384])
def test_split_sweep_is_bitwise_the_whole_sweep(cuda_device, K):
    """The interior and both boundary calls into one full carry give the
    whole sweep's data columns bit for bit, leave the carry's pads as they
    were, and their statistics' max is the whole sweep's."""
    args, pad, subs = _split_args(K, cuda_device, seed=K + 13)
    whole, wd, wa = tbcd.fused_banded_sweep(*args)
    out = torch.full_like(args[0], float("nan"))
    stats = [tbcd.fused_banded_sweep(*args, out=out, sub=sub)[1:]
             for sub in subs]
    torch.cuda.synchronize()
    assert torch.equal(out[:, pad:-pad], whole[:, pad:-pad])
    assert torch.isnan(out[:, :pad]).all() and torch.isnan(out[:, -pad:]).all()
    assert max(float(d) for d, _ in stats) == float(wd)
    assert max(float(a) for _, a in stats) == float(wa)


@pytest.mark.parametrize("form", ["whole", "rest", "sub"])
@pytest.mark.parametrize("K", [34, 47, 48])
def test_spot_panel_pass_is_bitwise_the_tile_pass_on_the_card(
        cuda_device, K, form):
    """Kernel #1 at K = 34, 47 (a last panel of 15 rows) and 48 through
    the spot-panel pass, against kernel #2's tile pass on the banded sums
    (with the same rest table for ``ns_rest``): the whole sweep, the whole
    sweep with ``ns_rest``, and a split sweep's three calls into one full
    carry give the same data columns and statistics bit for bit."""
    p, tp, args, nsr = _rest_args(K, cuda_device, seed=K + 31)
    carry, Xty_t, XtX, masks, inv, lam, rho, offsets, h, block = args
    n, pad, m = Xty_t.shape[1], h * block, Xty_t.shape[1] // block
    spot = tbcd.fused_banded_sweep.spot_panel_launches
    rest = nsr if form == "rest" else None
    out = torch.full_like(carry, float("nan"))
    stats = [tbcd.fused_banded_sweep(*args, out=out, sub=sub,
                                     ns_rest_t=rest)[1:]
             for sub in (((h, h, m - 2 * h), (0, 0, h), (m - h, m - h, h))
                         if form == "sub" else (None,))]
    beta_t = carry[:, pad:pad + n].contiguous()
    table = tp["rest_t"] if form == "rest" else torch.zeros(
        (0, n), dtype=torch.int32, device=cuda_device)
    ns = tbcd.neighbor_sum_banded(beta_t, offsets, masks.float(), table)
    tile, td, ta = tbcd.coordinate_descent_block(beta_t, Xty_t, XtX, ns, inv,
                                                 lam, rho)
    torch.cuda.synchronize()
    assert tbcd.fused_banded_sweep.spot_panel_launches == spot + len(stats)
    assert torch.equal(out[:, pad:pad + n], tile)
    assert max(float(d) for d, _ in stats) == float(td)
    assert max(float(a) for _, a in stats) == float(ta)


@pytest.mark.parametrize("form", ["whole", "rest", "sub"])
@pytest.mark.parametrize("K", WIDE_KS)
def test_wide_tile_pass_is_bitwise_fused_and_unfused_on_the_card(
        cuda_device, K, form):
    """Kernel #1 at 256 < K <= ``KERNEL_MAX_K`` (the tile pass's one-block
    instances) against kernel #2 on the banded sums (with the same rest
    table for ``ns_rest``): the whole sweep, the whole sweep with
    ``ns_rest``, and a split sweep's three calls into one full carry give
    the same data columns and statistics bit for bit; each launch of
    either kernel counts on ``.wide_launches``."""
    p, tp, args, nsr = _rest_args(K, cuda_device, seed=K + 37)
    carry, Xty_t, XtX, masks, inv, lam, rho, offsets, h, block = args
    n, pad, m = Xty_t.shape[1], h * block, Xty_t.shape[1] // block
    wide = (tbcd.fused_banded_sweep.wide_launches,
            tbcd.coordinate_descent_block.wide_launches)
    rest = nsr if form == "rest" else None
    out = torch.full_like(carry, float("nan"))
    stats = [tbcd.fused_banded_sweep(*args, out=out, sub=sub,
                                     ns_rest_t=rest)[1:]
             for sub in (((h, h, m - 2 * h), (0, 0, h), (m - h, m - h, h))
                         if form == "sub" else (None,))]
    beta_t = carry[:, pad:pad + n].contiguous()
    table = tp["rest_t"] if form == "rest" else torch.zeros(
        (0, n), dtype=torch.int32, device=cuda_device)
    ns = tbcd.neighbor_sum_banded(beta_t, offsets, masks.float(), table)
    tile, td, ta = tbcd.coordinate_descent_block(beta_t, Xty_t, XtX, ns, inv,
                                                 lam, rho)
    torch.cuda.synchronize()
    assert (tbcd.fused_banded_sweep.wide_launches,
            tbcd.coordinate_descent_block.wide_launches) == (
                wide[0] + len(stats), wide[1] + 1)
    assert torch.equal(out[:, pad:pad + n], tile)
    assert max(float(d) for d, _ in stats) == float(td)
    assert max(float(a) for _, a in stats) == float(ta)


@pytest.mark.parametrize("side", [18, 20, 22])
def test_wide_tile_pass_with_a_ragged_last_block_on_the_card(cuda_device,
                                                             side):
    """Kernel #1 at K = 338 on grids whose carry ends on a ragged block of
    64 columns (20, 32 and 60 columns left): its data columns and
    statistics bit for bit kernel #2's tile pass on the banded sums, the
    pad columns zero, one launch on ``.wide_launches``."""
    K = 338
    p = fused_problem(side=side, n_types=K, seed=side, block=2 * side)
    tp = as_torch(p, cuda_device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    n, pad = tp["Xty_t"].shape[1], p["h"] * p["block"]
    assert (n + 2 * pad) % 64 == {18: 20, 20: 32, 22: 60}[side]
    wide = tbcd.fused_banded_sweep.wide_launches
    out, d, a = tbcd.fused_banded_sweep(
        tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
        p["offsets"], p["h"], p["block"])
    beta_t = tp["carry"][:, pad:pad + n].contiguous()
    ns = tbcd.neighbor_sum_banded(
        beta_t, p["offsets"], tp["masks"].float(),
        torch.zeros((0, n), dtype=torch.int32, device=cuda_device))
    tile, td, ta = tbcd.coordinate_descent_block(beta_t, tp["Xty_t"],
                                                 tp["XtX"], ns, inv, 0.5,
                                                 0.1)
    torch.cuda.synchronize()
    assert tbcd.fused_banded_sweep.wide_launches == wide + 1
    assert torch.equal(out[:, pad:pad + n], tile)
    assert (out[:, :pad] == 0).all() and (out[:, -pad:] == 0).all()
    assert float(d) == float(td) and float(a) == float(ta)


def test_sub_range_off_the_carry_raises(cuda_device):
    args, _, _ = _split_args(20, cuda_device)
    m = args[1].shape[1] // args[-1]
    with pytest.raises(ValueError, match="leaves the carry"):
        tbcd.fused_banded_sweep(*args, sub=(1, 0, m))


def _mesh_problem(K, seed=0):
    from flashdeconv_tpu_torch.utils.graph import grid_coords

    coords = grid_coords(side=96)
    rng = np.random.RandomState(seed)
    X = rng.randn(K, 2 * K + 8)
    Y = np.abs(rng.randn(coords.shape[0], K)) @ X \
        + 0.05 * rng.randn(coords.shape[0], X.shape[1])
    return Y, X, build_knn_graph(coords, k=6), coords


@pytest.mark.parametrize("K", [20, 96])
@pytest.mark.parametrize("n_shards", [2, 3])
def test_banded_mesh_on_one_card_is_bitwise_the_fused_tier(cuda_device,
                                                           n_shards, K):
    """Shards on one card (their own streams), split and unsplit, and the
    unfused mesh (blocks of one spot: kernel #2 per shard): the same
    sweeps and beta as the single-device fused tier, bit for bit. Blocks
    of 256 spots give each shard the 2h + 1 blocks the split needs."""
    from flashdeconv_tpu_torch.parallel import GspmdBandedProblem

    Y, X, A, coords = _mesh_problem(K, seed=K)
    kw = dict(lambda_=0.3, rho=0.01, tol=1e-4)
    single = tsolver.prepare_bcd(Y, X, A, coords=coords, device=cuda_device)
    assert single.use_fused_banded
    ref, info = single.solve(max_iter=40, **kw)
    prob = GspmdBandedProblem(Y, X, A, mesh=(cuda_device,) * n_shards,
                              fused_block=256)
    assert prob.use_fused
    for overlap in (False, True):
        before = tbcd.fused_banded_sweep.sub_launches
        beta, it, _ = prob._run(max_iter=40, overlap=overlap, **kw)
        torch.cuda.synchronize()
        assert it == info["n_iterations"]
        np.testing.assert_array_equal(beta.double().cpu().numpy(), ref)
        split = tbcd.fused_banded_sweep.sub_launches - before
        assert split == (3 * n_shards * it if overlap else 0)
    unfused = GspmdBandedProblem(Y, X, A, mesh=(cuda_device,) * n_shards,
                                 fused_block=1)
    assert not unfused.use_fused
    before = _launches(tbcd.coordinate_descent_block, K)
    beta, sh = unfused.solve(max_iter=40, **kw)
    assert sh["n_iterations"] == info["n_iterations"]
    np.testing.assert_array_equal(beta, ref)
    assert (_launches(tbcd.coordinate_descent_block, K) - before
            == n_shards * sh["n_iterations"])


def test_halo_plan_on_one_card_matches_the_gather_tier(cuda_device):
    from flashdeconv_tpu_torch.parallel import sharded_bcd_solve

    p = gather_problem(n=5000, n_types=12, seed=6)
    rng = np.random.RandomState(7)
    X = rng.randn(12, 48)
    Y = np.abs(rng.randn(5000, 12)) @ X + 0.05 * rng.randn(5000, 48)
    A = build_knn_graph(p["coords"], k=6)
    ref, info = tsolver.bcd_solve(Y, X, A, coords=p["coords"],
                                  device=cuda_device)
    before = tbcd.coordinate_descent_block.launches
    beta, sh = sharded_bcd_solve(Y, X, A, coords=p["coords"],
                                 mesh=(cuda_device,) * 2, strategy="halo")
    assert sh["n_iterations"] == info["n_iterations"]
    assert tbcd.coordinate_descent_block.launches - before == 2 * \
        sh["n_iterations"]
    assert np.abs(beta - ref).max() <= 1e-5


# -- the CountSketch projection kernel -------------------------------------------

def _cs_operands(n, g, d, device, seed=0):
    from flashdeconv_tpu_torch.core.sketching import make_countsketch_op

    rng = np.random.default_rng(seed)
    Y = rng.random((n, g), dtype=np.float32) * 6.0
    Y *= rng.random((n, g)) < 0.4
    op = make_countsketch_op(g, d, rng.random(g) + 0.1, random_state=seed)
    return (Y, op, torch.from_numpy(Y).to(device),
            torch.from_numpy(op.buckets).to(device),
            torch.from_numpy(op.weights.astype(np.float32)).to(device))


@pytest.mark.parametrize("n,g,d", [(1024, 4097, 512), (1024, 4097, 100),
                                   (1024, 4097, 2048), (1029, 1100, 64)])
def test_countsketch_kernel_matches_plain_version(cuda_device, n, g, d):
    """Within 2e-5 * max(max|ref|, 1) of the plain version and of scipy in
    f64 (the JAX package's CountSketch bound); two calls bitwise equal."""
    from flashdeconv_tpu_torch.ops import countsketch as tcs

    Y, op, Yt, b, w = _cs_operands(n, g, d, cuda_device, seed=n + d)
    before = tcs.countsketch_project_kernel.launches
    out = torch.full((n, d), float("nan"), device=cuda_device)
    got = tcs.countsketch_project_kernel(Yt, b, w, d, out=out)
    again = tcs.countsketch_project_kernel(Yt, b, w, d)
    ref = tcs.countsketch_project_reference(Yt, b, w, d)
    torch.cuda.synchronize()
    assert got is out
    assert tcs.countsketch_project_kernel.launches == before + 2
    assert torch.equal(got, again)
    tol = 2e-5 * max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= tol
    exact = Y.astype(np.float64) @ op.to_csr()
    assert np.abs(got.cpu().numpy() - exact).max() <= tol


@pytest.mark.parametrize("n,g,use_kernel,launched", [
    (1024, 4096, None, 1), (1023, 4096, None, 0), (1024, 4095, None, 0),
    (300, 1100, True, 1), (2048, 5001, False, 0),
])
def test_countsketch_project_route_on_the_card(cuda_device, n, g,
                                               use_kernel, launched):
    from flashdeconv_tpu_torch.ops import countsketch as tcs

    Y, op, _, _, _ = _cs_operands(n, g, 128, cuda_device, seed=g)
    before = tcs.countsketch_project_kernel.launches
    got = tcs.countsketch_project(Y, op, use_kernel=use_kernel,
                                  device=cuda_device)
    torch.cuda.synchronize()
    assert tcs.countsketch_project_kernel.launches - before == launched
    exact = Y.astype(np.float64) @ op.to_csr()
    tol = 2e-5 * max(float(np.abs(exact).max()), 1.0)
    assert np.abs(got.cpu().numpy() - exact).max() <= tol


def test_dense_sketch_data_launches_the_kernel_once(cuda_device):
    """``backend="auto"`` on the card: dense Y (1,024 x 4,100) through the
    kernel, X (3 rows) through the matmul; f32 host arrays back, within
    1e-5 of the host route."""
    from flashdeconv_tpu_torch.core.sketching import sketch_data
    from flashdeconv_tpu_torch.ops import countsketch as tcs

    rng = np.random.RandomState(0)
    Y, X, lev = rng.rand(1024, 4100), rng.rand(3, 4100), rng.rand(4100)
    before = tcs.countsketch_project_kernel.launches
    ys, xs, _ = sketch_data(Y, X, 256, lev, random_state=0,
                            device=cuda_device)
    assert tcs.countsketch_project_kernel.launches == before + 1
    assert ys.dtype == xs.dtype == np.float32
    hy, hx, _ = sketch_data(Y, X, 256, lev, random_state=0, backend="host")
    np.testing.assert_allclose(ys, hy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xs, hx, rtol=1e-5, atol=1e-5)


# -- the fetch of beta, return_device and the streamed Xty feed ----------------------

@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "uint8"])
@pytest.mark.parametrize("chunk", [1 << 12, 1 << 25])
def test_fetch_is_bitwise_the_host_copy(cuda_device, dtype, chunk):
    """``fetch_to_host`` through the pinned staging ring (many chunks, and
    one), each read only after its copy's event: bit for bit
    ``tensor.cpu()`` cast on the host, on a tensor a kernel just wrote."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    t = torch.rand((3001, 7), generator=g, device=cuda_device) * 200.0
    t = t.to(getattr(torch, dtype))
    want, out = ((torch.int64, np.int64) if dtype == "uint8"
                 else (torch.float64, np.float64))
    got = tsolver.fetch_to_host(t * 1, out, chunk_bytes=chunk)
    np.testing.assert_array_equal(got, t.cpu().to(want).numpy())


@pytest.mark.parametrize("grid", [True, False])
def test_return_device_is_the_host_solve(cuda_device, grid):
    """The fused (a 96 x 96 grid) and gather tiers: ``return_device`` gives
    the contiguous f32 beta on the card, whose host copy is the default
    solve's f64 beta bit for bit."""
    rng = np.random.RandomState(7)
    coords = grid_coords(side=96) if grid else rng.rand(5000, 2) * 70
    X = rng.randn(10, 48)
    Y = np.abs(rng.randn(coords.shape[0], 10)) @ X \
        + 0.05 * rng.randn(coords.shape[0], 48)
    prob = tsolver.prepare_bcd(Y, X, build_knn_graph(coords, k=6),
                               coords=coords, device=cuda_device)
    assert prob.use_fused_banded == grid
    host, info = prob.solve()
    dev, info_d = prob.solve(return_device=True)
    assert dev.is_cuda and dev.dtype == torch.float32 and dev.is_contiguous()
    assert info == info_d
    np.testing.assert_array_equal(dev.cpu().double().numpy(), host)


def test_streamed_xty_is_the_host_cast(cuda_device):
    """Chunks of a host Xty streamed through two pinned buffers land on the
    card as their f32 cast, bit for bit, with the partial YtY summed."""
    from flashdeconv_tpu_torch.core.deconv import stream_xty

    rng = np.random.RandomState(3)
    xty = rng.randn(10_000, 20) * 100.0
    chunks = ((a, min(a + 3000, 10_000), xty[a:a + 3000], float(a))
              for a in range(0, 10_000, 3000))
    got, yty = stream_xty(chunks, 10_000, 20, cuda_device)
    assert got.is_cuda and yty == 0.0 + 3000 + 6000 + 9000
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  xty.astype(np.float32))


def _kernel_counts():
    return tuple(getattr(w, c) for w in (tbcd.fused_banded_sweep,
                                         tbcd.coordinate_descent_block)
                 for c in ("launches", "large_k_launches", "sub_launches",
                           "rest_launches") if hasattr(w, c))


@pytest.mark.parametrize("dtype,K", [(np.float64, 20),
                                     (np.float32, tbcd.KERNEL_MAX_K + 1),
                                     (np.float64, tbcd.KERNEL_MAX_K + 1)])
@pytest.mark.parametrize("grid", [True, False])
def test_xla_tier_on_the_card_matches_the_cpu(cuda_device, grid, dtype, K):
    """f64, and K > ``KERNEL_MAX_K`` (257 while the kernels stopped at
    256), take the XLA tier on the card (the unfused banded
    form on a 96 x 96 grid, the gather form on irregular coordinates),
    launch no kernel, and give the CPU solve's sweeps with beta within
    1e-12 (f64) or 1e-5 (f32) of max|beta|: only the FMA contraction of
    the card's elementwise kernels differs. ``return_device`` keeps the
    solve dtype."""
    rng = np.random.RandomState(9)
    coords = grid_coords(side=96) if grid else rng.rand(3000, 2) * 55
    n = coords.shape[0]
    X = rng.randn(K, K + 32)
    Y = rng.dirichlet(np.ones(K), size=n) @ X + 0.05 * rng.randn(n, K + 32)
    A = build_knn_graph(coords, k=6)
    probs = [tsolver.prepare_bcd(Y, X, A, coords=coords, dtype=dtype,
                                 device=d) for d in ("cpu", cuda_device)]
    assert [type(p.tier).__name__ for p in probs] == [
        "BandedTier" if grid else "GatherTier"] * 2
    assert not probs[1].tier.uses_kernel
    ref, rinfo = probs[0].solve(max_iter=60)
    before = _kernel_counts()
    dev, info = probs[1].solve(max_iter=60, return_device=True)
    assert _kernel_counts() == before
    assert dev.is_cuda and dev.dtype == (
        torch.float64 if dtype == np.float64 else torch.float32)
    assert info["n_iterations"] == rinfo["n_iterations"]
    bound = 1e-12 if dtype == np.float64 else 1e-5
    got = dev.cpu().double().numpy()
    assert np.abs(got - ref).max() <= bound * np.abs(ref).max()


def test_large_k_dominant_on_the_card_is_int32(cuda_device):
    """A K = 257 fit on the card (the gather tier's kernel #2a since the
    kernels take K to 384; the XLA tier before) fetches its argmax as
    int32, equal to the host argmax of its proportions."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.core import deconv as tdeconv

    rng = np.random.RandomState(11)
    K, n, g = 257, 2000, 900
    X = rng.gamma(2.0, 1.0, size=(K, g))
    Y = rng.poisson(rng.dirichlet(np.ones(K), size=n) @ X * 20).astype(float)
    wire = []
    real = tdeconv.fetch_to_host

    def spy(t, *a, **k):
        wire.append(t.dtype)
        return real(t, *a, **k)

    tdeconv.fetch_to_host = spy
    try:
        model = FlashDeconv(outputs=("proportions", "dominant"),
                            sketch_dim=512, n_hvg=800, n_markers_per_type=2,
                            max_iter=10, device=cuda_device)
        model.fit(Y, X, rng.rand(n, 2) * 45)
    finally:
        tdeconv.fetch_to_host = real
    assert torch.int32 in wire and torch.uint8 not in wire
    np.testing.assert_array_equal(model.dominant_,
                                  np.argmax(model.proportions_, axis=1))


# -- the gather tier's neighbour-sum kernel ----------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _tissue_table(device):
    """The (D, n) int32 neighbour table, sentinel n, of the benchmark's
    tissue section (``portbench/configs/vhd8um_tissue_k20.json``: its
    layout and kNN graph), on ``device``."""
    sys.path.insert(0, str(ROOT))
    from portbench.inputs import knn_graph, layout_coords

    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "vhd8um_tissue_k20.json").read_text())
    coords = layout_coords(cfg["layout"])
    nbr = adjacency_to_padded(knn_graph(coords, cfg["k_neighbors"]))[0]
    return torch.from_numpy(np.ascontiguousarray(nbr.T, dtype=np.int32)
                            ).to(device)


def _f32_bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("K", [20, 96])
def test_neighbor_sum_kernel_is_bitwise_the_plain_loop(cuda_device, K):
    """At the tissue's shape (417,768 spots, D = 10): the kernel's sums
    from the unpadded carry (sentinel n) and from the padded copy are the
    plain loop's bit for bit, one launch each."""
    nbr = _tissue_table(cuda_device)
    assert tuple(nbr.shape) == (10, 417_768)
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    beta = torch.randn((K, nbr.shape[1]), generator=gen,
                       device=cuda_device)
    ext = tbcd.with_sentinel(beta)
    ref = tbcd.neighbor_sum_reference(beta, nbr)
    before = tbcd.neighbor_sum.launches
    got = tbcd.neighbor_sum(beta, nbr)
    padded = tbcd.neighbor_sum(ext, nbr)
    torch.cuda.synchronize()
    assert tbcd.neighbor_sum.launches == before + 2
    assert torch.equal(_f32_bits(got), _f32_bits(ref))
    assert torch.equal(_f32_bits(padded), _f32_bits(ref))


@pytest.mark.parametrize("hubs", [False, True])
def test_gather_solve_through_the_kernel_is_the_plain_loop(cuda_device,
                                                           hubs,
                                                           monkeypatch):
    """A gather-tier ``BCDProblem.solve`` (5,000 irregular spots, K = 12;
    with ``hubs``, a degree cap of 6 and its overflow table) gives the
    same beta bits and sweeps through the neighbour-sum kernel as through
    the plain loop, and launches it once a sweep and once for the
    objective (twice each with the hubs' table); the plain route launches
    nothing."""
    p = gather_problem(n=5000, n_types=12, seed=4)
    rng = np.random.RandomState(5)
    X = rng.randn(12, 48)
    Y = np.abs(rng.randn(5000, 12)) @ X + 0.05 * rng.randn(5000, 48)
    A = build_knn_graph(p["coords"], k=6)
    prob = tsolver.prepare_bcd(Y, X, A, coords=p["coords"],
                               max_degree=6 if hubs else None,
                               device=cuda_device)
    assert type(prob.tier).__name__ == "GatherTier"
    assert (prob.tier.overflow is not None) == hubs
    before = tbcd.neighbor_sum.launches
    beta, info = prob.solve()
    launched = tbcd.neighbor_sum.launches - before
    monkeypatch.setattr(tbcd, "neighbor_sum_kernel_takes", lambda t: False)
    beta_p, info_p = prob.solve()
    assert tbcd.neighbor_sum.launches - before == launched
    assert launched == (2 if hubs else 1) * (info["n_iterations"] + 1)
    assert info["n_iterations"] == info_p["n_iterations"]
    assert info["final_objective"] == info_p["final_objective"]
    np.testing.assert_array_equal(beta, beta_p)


def test_fused_solve_launches_no_neighbor_sum(cuda_device):
    """The fused tier's sweeps and objective never call the gather
    tier's neighbour sums."""
    prob = _grid_problem(20)
    before = tbcd.neighbor_sum.launches
    prob.solve()
    assert tbcd.neighbor_sum.launches == before
