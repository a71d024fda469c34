"""The port's profiler spans, on the CPU.

Under ``torch.profiler`` (CPU activity) the solve and the fit open the
program's ``flashdeconv.*`` spans at their layer boundaries: every
``flashdeconv.solve`` holds one ``flashdeconv.solve.sweep`` a sweep and one
``flashdeconv.solve.objective``, on each tier a small problem reaches and
on the halo plan and the banded mesh of a two-shard CPU mesh; a
fit opens each stage, prepare and output span once, nested as the layers
are, and each stage span lasts as long as its ``timings_`` entry, whose
keys stay as they were. With no profiler running, neither a solve nor a
fit enters a single span.
"""

import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import flashdeconv_tpu_torch
from conftest import make_synthetic
from flashdeconv_tpu_torch.core import solver as tsolver
from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords

torch.set_num_threads(2)

SOLVE = dict(rho=0.01, max_iter=50, tol=1e-4)
STAGES = ("gene_selection", "preprocess", "sketch", "spatial_graph",
          "lambda_tuning", "solve")
#: Each span of a device-output fit, and the span it opens inside.
FIT_NESTING = {
    **{f"flashdeconv.fit.{s}": None for s in STAGES},
    "flashdeconv.fit.prepare": "flashdeconv.fit.solve",
    "flashdeconv.prepare.graph_plan": "flashdeconv.fit.prepare",
    "flashdeconv.prepare.tier": "flashdeconv.fit.prepare",
    "flashdeconv.solve": "flashdeconv.fit.solve",
    "flashdeconv.solve.objective": "flashdeconv.solve",
    "flashdeconv.fit.outputs": "flashdeconv.fit.solve",
}


def program_spans(prof):
    """``(name, start_ns, end_ns)`` of every ``flashdeconv.*`` span."""
    return sorted(
        (e.name(), int(e.start_ns()), int(e.start_ns() + e.duration_ns()))
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("flashdeconv."))


def inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _problem(tier: str):
    """A 400-spot problem that takes ``tier``: a 20 x 20 grid through a
    plan built past the 8,192-spot gate (f32: the fused tier; f64: the
    unfused banded form of the XLA tier), or irregular coordinates; the
    ``halo`` plan (irregular) or the ``banded`` mesh (the grid) of two CPU
    shards."""
    rng = np.random.RandomState(5)
    side, K = 20, 4
    n = side * side
    coords = (rng.rand(n, 2) * side if tier in ("GatherTier", "halo")
              else grid_coords(side=side))
    A = build_knn_graph(coords, k=6)
    X = rng.rand(K, 32)
    Y = rng.dirichlet(np.ones(K), size=n) @ X + 0.01 * rng.rand(n, 32)
    if tier in ("halo", "banded"):
        prob = prepare_sharded_bcd(Y, X, A, coords=coords, mesh=("cpu",) * 2,
                                   strategy=tier, device="cpu")
        assert prob.strategy == tier
        return prob
    plan = (None if tier == "GatherTier"
            else tsolver.GraphDecomposition(A, 8192, coords))
    dtype = np.float64 if tier == "BandedTier" else np.float32
    prob = tsolver.prepare_bcd(Y, X, A, dtype=dtype, coords=coords,
                               graph_plan=plan, device="cpu")
    assert type(prob.tier).__name__ == tier
    return prob


@pytest.mark.parametrize("tier", ["FusedBandedTier", "BandedTier",
                                  "GatherTier", "halo", "banded"])
def test_each_solve_holds_its_sweeps_and_one_objective(tier):
    prob = _problem(tier)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        infos = [prob.solve(lambda_=lam, **SOLVE)[1] for lam in (0.05, 0.2)]
    spans = program_spans(prof)
    solves = [s for s in spans if s[0] == "flashdeconv.solve"]
    assert len(solves) == len(infos)
    for solve, info in zip(solves, infos):
        assert info["n_iterations"] >= 2
        held = [s[0] for s in spans if s is not solve and inside(s, solve)]
        assert held.count("flashdeconv.solve.sweep") == info["n_iterations"]
        assert held.count("flashdeconv.solve.objective") == 1
        assert len(held) == info["n_iterations"] + 1
    # Every sweep span lies inside a solve span.
    assert all(any(inside(s, p) for p in solves) for s in spans)


@pytest.fixture(scope="module")
def traced_fit():
    """A small device-output fit under the profiler, and its spans."""
    Y, X, coords, _ = make_synthetic(n_spots=400, n_genes=300, n_types=4,
                                     seed=2, sparse_output=True)
    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu",
                                              device_outputs=True)
    # The fit's graph threads may hold the interpreter lock between a
    # stage's span clock and its timer's; a short switch interval hands it
    # back within microseconds rather than the default 5 ms.
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            model.fit(Y, X, coords)
    finally:
        sys.setswitchinterval(interval)
    return model, program_spans(prof)


def test_a_fit_opens_each_span_once_nested_by_layer(traced_fit):
    model, spans = traced_fit
    names = [s[0] for s in spans]
    for name, parent in FIT_NESTING.items():
        assert names.count(name) == 1, name
        if parent is not None:
            span = spans[names.index(name)]
            assert inside(span, spans[names.index(parent)]), name
    sweeps = [s for s in spans if s[0] == "flashdeconv.solve.sweep"]
    assert len(sweeps) == model.info_["n_iterations"]
    solve = spans[names.index("flashdeconv.solve")]
    assert all(inside(s, solve) for s in sweeps)
    assert set(names) == set(FIT_NESTING) | {"flashdeconv.solve.sweep"}


def test_stage_spans_last_as_long_as_their_timings(traced_fit):
    model, spans = traced_fit
    for stage, seconds in model.timings_.items():
        (span,) = [s for s in spans if s[0] == f"flashdeconv.fit.{stage}"]
        span_s = (span[2] - span[1]) * 1e-9
        assert abs(span_s - seconds) <= max(0.05 * seconds, 2e-3), stage


def test_timings_keep_their_keys(traced_fit):
    model, _ = traced_fit
    assert tuple(model.timings_) == STAGES
    Y, X, coords, _ = make_synthetic(n_spots=400, n_genes=300, n_types=4,
                                     seed=2, sparse_output=True)
    untraced = flashdeconv_tpu_torch.FlashDeconv(device="cpu").fit(
        Y, X, coords)
    assert tuple(untraced.timings_) == STAGES


def test_no_span_is_entered_without_a_profiler(monkeypatch):
    """Counts every entry into a ``record_function`` span: none without a
    profiler, and the count sees them with one (so the stand-in is the
    entry that ``record_function`` calls)."""
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, args=None):
        entered.append(name)
        return enter(name, args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    Y, X, coords, _ = make_synthetic(n_spots=400, n_genes=300, n_types=4,
                                     seed=2, sparse_output=True)
    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu",
                                              device_outputs=True)
    model.fit(Y, X, coords)
    prob = _problem("FusedBandedTier")
    prob.solve(lambda_=0.1, **SOLVE)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        prob.solve(lambda_=0.1, **SOLVE)
    assert entered[0] == "flashdeconv.solve"
    assert "flashdeconv.solve.sweep" in entered
