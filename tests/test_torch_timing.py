"""The port's ``utils/timing.py`` against the JAX package's, on the CPU.

``fori_difference_windows`` is fed the same scripted run times as the JAX
function and must return the same windows, or raise after the same number
of runs. The sweep timer's ``n`` sweeps are held bitwise against
``bcd_iterate_banded_fused`` with ``tol=0, max_iter=n`` (the plain version
of kernel #1 on the CPU), with and without rest tables, at K = 20 (the
register pass's range) and K = 48 (the panel pass's); the timer built from
a prepared problem sweeps that problem's operands as its solve does.
``trace`` is a no-op without a trace directory, and with one a fit writes
one Chrome trace per traced stage and the same bits as an untraced fit.
"""

import json

import numpy as np
import pytest
import torch

import flashdeconv_tpu.utils.timing as j_timing
import flashdeconv_tpu_torch.utils.timing as t_timing
from conftest import make_synthetic
from flashdeconv_tpu_torch import FlashDeconv
from flashdeconv_tpu_torch.core.solver import prepare_bcd
from flashdeconv_tpu_torch.ops import bcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph
from torch_problems import as_torch, dropped_grid_coords, fused_problem, \
    with_rest

torch.set_num_threads(2)

LAM, RHO = 0.3, 0.02


# -- fori_difference_windows --------------------------------------------------

class Scripted:
    """``timed(n)`` that returns the next scripted time, whatever ``n``,
    and records the lengths it was asked for."""

    def __init__(self, times):
        self.times, self.asked = list(times), []

    def __call__(self, n):
        self.asked.append(n)
        return self.times.pop(0)


def _script(kind, n_calls=2 + 2 * 28):
    rng = np.random.RandomState(4)
    short = 0.010 + 0.001 * rng.rand(n_calls)
    long_ = 0.060 + 0.001 * rng.rand(n_calls)
    times = np.where(np.arange(n_calls) % 2 == 0, short, long_)
    if kind == "some_non_positive":
        # Every third long run comes back faster than its short run.
        times[5::6] = 0.005
    elif kind == "all_non_positive":
        times[1::2] = 0.001
    return times.tolist()


@pytest.mark.parametrize("kind", ["all_positive", "some_non_positive"])
def test_difference_windows_match_jax(kind):
    port, ref = Scripted(_script(kind)), Scripted(_script(kind))
    got = t_timing.fori_difference_windows(port, n_short=3, n_long=23,
                                           windows=9)
    want = j_timing.fori_difference_windows(ref, n_short=3, n_long=23,
                                            windows=9)
    assert got == want and len(got) == 9
    assert all(w > 0 for w in got)
    assert port.asked == ref.asked
    resampled = kind == "some_non_positive"
    assert (len(port.asked) > 2 + 2 * 9) == resampled


def test_all_non_positive_windows_raise_like_jax():
    port, ref = (Scripted(_script("all_non_positive")),
                 Scripted(_script("all_non_positive")))
    with pytest.raises(RuntimeError, match="all 16 timing windows"):
        t_timing.fori_difference_windows(port, windows=6)
    with pytest.raises(RuntimeError, match="all 16 timing windows"):
        j_timing.fori_difference_windows(ref, windows=6)
    assert port.asked == ref.asked == [5, 30] * 17


# -- the sweep timer ----------------------------------------------------------

def _operands(K, rest):
    p = fused_problem(side=64, n_types=K, seed=K)
    if rest:
        p = with_rest(p, seed=K)
    return as_torch(p)


@pytest.mark.parametrize("rest", [False, True])
@pytest.mark.parametrize("K", [20, 48])
def test_timed_sweeps_are_the_solve_loops(K, rest):
    """``fused_sweeps`` (what ``timed(n)`` runs) against the production
    loop, bitwise, leaving the start carry as it was."""
    p, n = _operands(K, rest), 4
    inv = bcd.gs_inv_den(p["XtX"], p["nnb"], LAM)
    tables = dict(rest_touched=p.get("touched"),
                  rest_slots=p.get("slot_cols"))
    start = p["carry"].clone()
    got = t_timing.fused_sweeps(
        p["carry"], p["Xty_t"], p["XtX"], p["masks"], inv, LAM, RHO,
        p["offsets"], p["h"], p["block"], n, **tables)
    assert torch.equal(p["carry"], start)
    ref, it, _ = bcd.bcd_iterate_banded_fused(
        start, p["Xty_t"], p["XtX"], p["masks"], p["nnb"], LAM, RHO, 0.0,
        n, p["offsets"], p["h"], p["block"],
        rest_touched=tables["rest_touched"],
        rest_slot_cols=tables["rest_slots"])
    assert it == n
    assert torch.equal(got, ref)


def test_timer_looks_up_the_sweep_at_call_time_and_reads_nothing(
        monkeypatch):
    """Each timed run launches ``n`` sweeps through whatever
    ``ops.bcd.fused_banded_sweep`` is then, and forms no stopping
    statistic."""
    p = _operands(6, rest=True)
    inv = bcd.gs_inv_den(p["XtX"], p["nnb"], LAM)
    timed = t_timing.fused_sweep_timer(
        p["carry"], p["Xty_t"], p["XtX"], p["masks"], inv, LAM, RHO,
        p["offsets"], p["h"], p["block"], rest_touched=p["touched"],
        rest_slots=p["slot_cols"])
    calls = []
    real = bcd.fused_banded_sweep

    def counted(*args, **kwargs):
        calls.append(kwargs["ns_rest_t"] is not None)
        return real(*args, **kwargs)

    def no_read(*args):
        raise AssertionError("the timed loop read a statistic")

    monkeypatch.setattr(bcd, "fused_banded_sweep", counted)
    monkeypatch.setattr(bcd, "rel_change", no_read)
    assert timed(3) > 0.0 and calls == [True] * 3


def test_timer_for_a_problem_sweeps_its_solve_operands(monkeypatch):
    """On a prepared fused problem with rest edges (a 100 x 100 grid, 5 %
    of its bins dropped) the timer's operands are the solve's: its sweeps
    from the zero carry are the tier's own, bitwise."""
    coords = dropped_grid_coords(100, 0.05)
    rng = np.random.RandomState(0)
    X = rng.randn(6, 40)
    Y = np.abs(rng.randn(coords.shape[0], 6)) @ X
    prob = prepare_bcd(Y, X, build_knn_graph(coords, k=6), coords=coords,
                       device="cpu")
    assert prob.use_fused_banded and prob.tier.rest_touched is not None
    seen = {}
    real = t_timing.fused_sweep_timer
    monkeypatch.setattr(t_timing, "fused_sweep_timer",
                        lambda *a, **kw: seen.update(args=a, kw=kw)
                        or real(*a, **kw))
    timed = t_timing.fused_sweep_timer_for(prob, 0.1, 0.01)
    windows = t_timing.fori_difference_windows(timed, n_short=1, n_long=2,
                                               windows=2)
    assert len(windows) == 2
    got = t_timing.fused_sweeps(*seen["args"], 3, **seen["kw"])
    zero = seen["args"][0].clone()
    assert not zero.any()
    ref, it, _ = prob.tier.iterate(
        zero, bcd.scalar(0.1, torch.float32),
        bcd.scalar(0.01 * prob.mean_diag, torch.float32), 0.0, 3)
    assert it == 3
    assert torch.equal(got, ref)


def test_timer_for_refuses_a_problem_off_the_fused_tier():
    coords = np.random.RandomState(1).rand(500, 2) * 22
    rng = np.random.RandomState(1)
    X = rng.randn(5, 30)
    prob = prepare_bcd(np.abs(rng.randn(500, 5)) @ X, X,
                       build_knn_graph(coords, k=6), coords=coords,
                       device="cpu")
    assert type(prob.tier).__name__ == "GatherTier"
    with pytest.raises(ValueError, match="fused banded kernel"):
        t_timing.fused_sweep_timer_for(prob, 0.1, 0.01)


# -- trace --------------------------------------------------------------------

def test_trace_is_a_no_op_without_a_directory(monkeypatch):
    monkeypatch.delenv("FLASHDECONV_TRACE_DIR", raising=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with t_timing.trace("stage"):
        x = torch.ones(3).sum()
    assert float(x) == 3.0


def _traces(directory):
    files = sorted(directory.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    assert events
    return events


def test_trace_writes_one_chrome_trace_per_name(tmp_path):
    with t_timing.trace("block", trace_dir=str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.get("name") for e in _traces(tmp_path / "block")}
    assert "aten::mm" in names


@pytest.fixture(scope="module")
def small_counts():
    Y, X, coords, _ = make_synthetic(n_spots=400, n_genes=300, n_types=5,
                                     sparse_output=True)
    return Y, X, coords


def test_traced_fit_writes_the_stages_and_the_same_bits(
        small_counts, tmp_path, monkeypatch):
    """A fit and a lambda path with ``FLASHDECONV_TRACE_DIR`` set: the
    ``sketch``, ``bcd_solve`` and ``bcd_lambda_path`` traces, and beta
    bitwise the untraced runs'."""
    Y, X, coords = small_counts
    kw = dict(device="cpu", sketch_dim=64, n_hvg=120, n_markers_per_type=8)
    plain = FlashDeconv(**kw).fit(Y, X, coords)
    plain_path = FlashDeconv(**kw).fit_lambda_path(Y, X, coords)
    monkeypatch.setenv("FLASHDECONV_TRACE_DIR", str(tmp_path))
    traced = FlashDeconv(**kw).fit(Y, X, coords)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "bcd_solve", "sketch"]
    _traces(tmp_path / "sketch")
    assert any(e.get("name") == "aten::index_select"
               for e in _traces(tmp_path / "bcd_solve"))
    np.testing.assert_array_equal(traced.beta_, plain.beta_)
    assert traced.info_["n_iterations"] == plain.info_["n_iterations"]
    traced_path = FlashDeconv(**kw).fit_lambda_path(Y, X, coords)
    _traces(tmp_path / "bcd_lambda_path")
    for a, b in zip(traced_path, plain_path):
        np.testing.assert_array_equal(a["beta"], b["beta"])
