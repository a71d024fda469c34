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
pass at K <= 64, the panel pass of 16 coordinates at 64 < K <= 256), so
the fused and unfused banded sweeps are bitwise equal to each other, and
two launches on the same operands are bitwise equal. The
CountSketch kernel is held to 2e-5 * max(max|ref|, 1) against its plain
version and an f64 projection (the JAX package's CountSketch bound), and
bitwise against itself.
"""

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph
from torch_problems import as_torch, fused_problem, gather_problem

pytestmark = pytest.mark.cuda


KS = [6, 20, 64, 65, 96, 128, 256]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _launches(wrapper, K):
    """The count of the kernel ``wrapper`` launches at K: its register
    form at K <= 64, its panel form above."""
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
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.fused_banded_sweep_reference(*args)
        out = torch.full_like(tp["carry"], float("nan"))
        got, d, a = tbcd.fused_banded_sweep(*args, out=out)
    torch.cuda.synchronize()
    assert _launches(tbcd.fused_banded_sweep, K) == before + 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
    pad = p["h"] * p["block"]
    assert (got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("K", [20, 96])
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


def _cd_args(p, lam=0.5, rho=0.1):
    tp = {k: torch.from_numpy(v).cuda() for k, v in p.items()
          if k != "coords"}
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(tp["beta_t"]), tp["nbr_t"])
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], lam).contiguous()
    return tp, [tp["beta_t"], tp["Xty_t"], tp["XtX"], ns, inv, lam, rho]


@pytest.mark.parametrize("K", KS)
def test_cd_kernel_matches_plain_version(cuda_device, K):
    """3,000 spots: a ragged tail after 11 full blocks of 256 (K <= 64) or
    93 full tiles of 32 (above)."""
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


@pytest.mark.parametrize("K", [65, 96, 128, 256])
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
