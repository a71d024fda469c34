"""The CUDA fused banded sweep against its plain PyTorch version.

Runs only where there is a card (marker ``cuda``; ``python -m pytest
--noconftest -m cuda tests/test_torch_kernels.py`` on a machine without
JAX): the kernel has no CPU mode. The card is
looked for inside a fixture, so every pytest worker collects the same
tests. Bounds: atol 5e-5 / rtol 1e-4 on beta and rtol 1e-4 on the
statistics — the kernel contracts multiply-adds into FMAs and sums the
XtX @ beta product in its own order, so it is not bitwise equal.
"""

import pytest
import torch

from flashdeconv_tpu_torch.ops import bcd as tbcd
from torch_problems import as_torch, fused_problem

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("K", [6, 20, 64])
def test_kernel_matches_plain_version(cuda_device, K):
    p = fused_problem(n_types=K, seed=K)
    tp = as_torch(p, cuda_device)
    inv = tbcd.gs_inv_den(tp["XtX"], tp["nnb"], 0.5).contiguous()
    args = (tp["carry"], tp["Xty_t"], tp["XtX"], tp["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    before = tbcd.fused_banded_sweep.launches
    with tbcd.full_f32_matmul():
        ref, rd, ra = tbcd.fused_banded_sweep_reference(*args)
        out = torch.full_like(tp["carry"], float("nan"))
        got, d, a = tbcd.fused_banded_sweep(*args, out=out)
    torch.cuda.synchronize()
    assert tbcd.fused_banded_sweep.launches == before + 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=1e-4)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=1e-4)
    pad = p["h"] * p["block"]
    assert (got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()
    assert (got >= 0).all()


@pytest.mark.parametrize("where", ["XtX", "inv_den", "lambda"])
def test_kernel_propagates_nan_like_plain_version(cuda_device, where):
    """A NaN operand gives NaN in the same places as the plain version
    and a NaN max_diff, so the sweep cannot pass for converged."""
    p = fused_problem(n_types=20, seed=1)
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
