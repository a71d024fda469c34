"""The configuration ``stereoseq_bin20_k34`` (K = 34, the Allen
whole-mouse-brain classes) on the port's normal path, and the fused tier's
objective kernel above the register pass (32 < K <= 56).

On the CPU: ``prepare_bcd`` and ``solve`` at K = 34 on grids made with
``portbench.inputs`` from the configuration's own file (side 32: the
gather tier; side 96: the fused tier; f64: the XLA tier), against the
benchmark's plain reference (``portbench/reference/solve.py``) in f64:
the same sweeps and beta within 1e-5 of max|beta_ref|, on three seeds.
The objective's dispatch, with the card faked (operands that report
``cuda:0``, a stand-in library that records each launch): a CUDA f32
carry at K = 20 and at K = 34 / 56 launches the kernel once, counted on
``launches`` and on ``large_k_launches`` respectively; K = 57 and 65, an
f64 carry and a CPU carry take the plain path and launch nothing.

On a card (marker ``cuda``; this file imports no JAX, so ``python -m
pytest --noconftest -m cuda tests/test_torch_objective_wide.py`` runs it
on a machine without JAX): the same K = 34 solve on the fused tier,
through kernel #1's panel pass and the objective kernel (one launch a
solve), against the reference in f64. The card is looked for inside a
fixture, so every pytest worker collects the same tests.
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.ops import _build
from flashdeconv_tpu_torch.ops import bcd as tbcd
from portbench import inputs
from portbench.reference import solve as ref_solve
from torch_problems import fused_problem

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "stereoseq_bin20_k34.json").read_text())
SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)
TIERS = {32: "GatherTier", 96: "FusedBandedTier"}
# Beta against the f64 reference, over max|beta_ref|: the benchmark's
# beta_gap limit is 2e-5; these sizes read at most ~1e-6 in f32.
BETA_GAP = 1e-5


def _section(side: int, seed: int, device="cpu"):
    """The configuration's sketch-space problem on a side x side grid:
    (Y, X, A, coords) on the host."""
    cfg = dict(CONFIG, layout=dict(CONFIG["layout"], side=side))
    coords = inputs.layout_coords(cfg["layout"])
    A = inputs.knn_graph(coords, int(cfg["k_neighbors"]))
    Y, X = inputs.sketch_problem(cfg, coords, seed, device)
    return Y.cpu().numpy(), X.cpu().numpy(), A, coords


def _solve_against_reference(side, dtype, seed, device):
    Y, X, A, coords = _section(side, seed, device)
    s = CONFIG["solve"]
    prob = tsolver.prepare_bcd(Y, X, A, coords=coords, dtype=dtype,
                               device=device)
    beta, info = prob.solve(lambda_=s["lambda"], rho=s["rho"], tol=s["tol"],
                            max_iter=s["max_iter"])
    X64 = X.astype(np.float64)
    ref = ref_solve.bcd(ref_solve.xty_from_sketch(Y, X, "f64", device),
                        X64 @ X64.T, A, s["lambda"], s["rho"], s["tol"],
                        s["max_iter"], "f64")
    return prob, beta, info, ref


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("side", sorted(TIERS))
def test_k34_solve_matches_the_plain_reference(side, dtype, seed):
    """K = 34 through ``prepare_bcd`` / ``solve`` on the CPU: the tier the
    grid's size and the dtype choose, the reference's sweeps, beta within
    ``BETA_GAP`` of it."""
    prob, beta, info, ref = _solve_against_reference(side, dtype, seed,
                                                     "cpu")
    want = TIERS[side] if dtype == np.float32 else "BandedTier"
    if dtype == np.float64 and side == 32:
        want = "GatherTier"
    assert type(prob.tier).__name__ == want
    assert prob.n_types == CONFIG["n_types"] == 34
    assert info["n_iterations"] == ref.n_iterations
    assert ref_solve.max_gap(torch.as_tensor(beta), ref.beta) <= BETA_GAP
    assert np.isfinite(info["final_objective"])


# -- the objective's dispatch, the card faked -------------------------------------

class OnCard:
    """A CPU tensor that reports ``device``: the wrappers read only its
    shape, dtype, device, contiguity and pointer before the launch."""

    def __init__(self, t: torch.Tensor, device="cuda:0"):
        self.t = t.contiguous()
        self.device = torch.device(device)
        self.shape, self.dtype = self.t.shape, self.t.dtype

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr()

    def new_empty(self, shape):
        return torch.zeros(shape, dtype=self.dtype)

    def reshape(self, *shape):
        return OnCard(self.t.reshape(*shape), self.device)


class FakeLib:
    """The fused kernels' library: each objective launch records its K and
    succeeds, its partials left at zero."""

    def __init__(self):
        self.objective_ks = []

    def fdt_fused_banded_objective_blocks(self, n_solve):
        return 3

    def fdt_fused_banded_objective(self, *args):
        self.objective_ks.append(args[10])
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "launch_stream",
                        lambda *ops: contextlib.nullcontext(0))
    plain = []

    def reference(*args, **kw):
        plain.append(args[0].shape[0])
        return torch.zeros((), dtype=torch.float64)

    monkeypatch.setattr(tbcd, "objective_terms_banded_fused_reference",
                        reference)
    return lib, plain


def _carry_args(K, dtype=torch.float32, device="cuda:0"):
    p = fused_problem(side=16, n_types=K, seed=K, block=64)
    wrap = (lambda a: OnCard(torch.from_numpy(a).to(dtype), device)) \
        if device != "cpu" else (lambda a: torch.from_numpy(a).to(dtype))
    return (wrap(p["carry"]), wrap(p["Xty_t"]), wrap(p["XtX"]), 5e3,
            p["offsets"], OnCard(torch.from_numpy(p["masks"]), device)
            if device != "cpu" else torch.from_numpy(p["masks"]),
            0.5, 0.1, p["h"], p["block"]), wrap(p["nnb"])


@pytest.mark.parametrize("K", [20, 34, 56])
def test_a_card_f32_carry_launches_the_objective_kernel(fake_card, K):
    """Up to ``OBJECTIVE_KERNEL_MAX_K`` (56) a CUDA f32 carry takes the
    kernel, once a call: on ``launches`` at K <= 32, on
    ``large_k_launches`` above."""
    lib, plain = fake_card
    args, nnb = _carry_args(K)
    before = (tbcd.fused_banded_objective.launches,
              tbcd.fused_banded_objective.large_k_launches)
    got = tbcd.objective_terms_banded_fused(*args, nnb=nnb)
    large = K > tbcd.REGISTER_PASS_MAX_K
    assert lib.objective_ks == [K] and plain == []
    assert (tbcd.fused_banded_objective.launches,
            tbcd.fused_banded_objective.large_k_launches) == (
        before[0] + (not large), before[1] + large)
    # Zero partials: the objective is 0.5 * YtY.
    assert float(got) == 2.5e3


@pytest.mark.parametrize("case", ["K57", "K65", "f64", "cpu"])
def test_other_carries_take_the_plain_objective(fake_card, case):
    """Above the kernel's K, in f64 and on the CPU the objective is the
    plain path's, and nothing launches."""
    lib, plain = fake_card
    K = {"K57": 57, "K65": 65}.get(case, 34)
    args, nnb = _carry_args(
        K, torch.float64 if case == "f64" else torch.float32,
        "cpu" if case == "cpu" else "cuda:0")
    before = (tbcd.fused_banded_objective.launches,
              tbcd.fused_banded_objective.large_k_launches)
    tbcd.objective_terms_banded_fused(*args, nnb=nnb)
    assert lib.objective_ks == [] and plain == [K]
    assert (tbcd.fused_banded_objective.launches,
            tbcd.fused_banded_objective.large_k_launches) == before


def test_the_kernel_wrapper_refuses_k_above_its_instances(fake_card):
    lib, _ = fake_card
    args, nnb = _carry_args(tbcd.OBJECTIVE_KERNEL_MAX_K + 1)
    carry, Xty_t, XtX, _, offsets, masks, _, _, h, block = args
    with pytest.raises(ValueError, match="K <= 56"):
        tbcd.fused_banded_objective_sums(carry, Xty_t, XtX, masks, nnb,
                                         offsets, h, block)
    assert lib.objective_ks == []


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_k34_solve_on_the_card_matches_the_plain_reference(cuda_device,
                                                            seed):
    """The fused tier at K = 34 on the card: kernel #1's panel pass once a
    sweep and the objective kernel once a solve (large-K forms), the
    reference's sweeps, beta within ``BETA_GAP`` of it."""
    counts = (tbcd.fused_banded_sweep.large_k_launches,
              tbcd.fused_banded_objective.large_k_launches,
              tbcd.fused_banded_objective.launches)
    with tbcd.full_f32_matmul():
        prob, beta, info, ref = _solve_against_reference(
            96, np.float32, seed, cuda_device)
    assert type(prob.tier).__name__ == "FusedBandedTier"
    assert (tbcd.fused_banded_sweep.large_k_launches,
            tbcd.fused_banded_objective.large_k_launches,
            tbcd.fused_banded_objective.launches) == (
        counts[0] + info["n_iterations"], counts[1] + 1, counts[2])
    assert info["n_iterations"] == ref.n_iterations
    assert ref_solve.max_gap(torch.as_tensor(beta), ref.beta) <= BETA_GAP
