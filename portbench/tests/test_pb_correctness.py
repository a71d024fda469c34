"""The comparison that decides ``correct``, at a size the CPU runs: the
port agrees with the plain reference in every cell; the control (the
reference in TF32, the precision below the configurations' float32) fails
a limit; and a run whose timed path is broken underneath comes out not
correct, for each fault a one-card cell can have. (The cells run on one
card, so there is no exchange between cards to leave out.)"""

from __future__ import annotations

import json

import pytest
import torch

from portbench import control, harness
from portbench.tests.conftest import REPO, copy_benchmark

CELLS = [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]]


def quiet(msg):
    pass


def run(root, cell, seed=2**31 + 7, seconds=0.3):
    return harness.run_cell(harness.Cell(cell, root=root), seed, seconds,
                            False, device="cpu", log=quiet)


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["compared"]) == set(harness.Cell(cell).limits)
    assert "setup_s" in r["metrics"]


def test_the_result_line_ends_with_the_compared_numbers(tiny_root):
    r = run(tiny_root, "vhd8um_tissue_k20.solve")
    assert list(r)[-1] == "compared"
    assert r["setup"]["tier"] == "GatherTier"


def test_a_section_off_its_tier_fails_set_up(tmp_path):
    root = copy_benchmark(tmp_path, tiny=True)
    path = root / "portbench/configs/vhd8um_tissue_k20.json"
    cfg = json.loads(path.read_text())
    cfg["tier"] = "FusedBandedTier"
    path.write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="GatherTier"):
        run(root, "vhd8um_tissue_k20.solve")


def test_every_solve_takes_a_lambda_of_its_own(tiny_root):
    cell = harness.Cell("stereoseq_bin20_k20.solve", root=tiny_root)
    lo, hi = cell.traffic["lambda_factor"]
    centre = cell.config["solve"]["lambda"]
    scans = []
    for seed in (2**31 + 3, 2**31 + 3, 2**31 + 4):
        state = cell.loop.setup(cell.config, cell.traffic, seed, "cpu",
                                quiet)
        scans.append([cell.loop.run_one(state)["output"]["lambda_"]
                      for _ in range(4)])
    assert scans[0] == scans[1] != scans[2]
    assert len(set(scans[0])) == 4
    assert all(lo * centre <= lam <= hi * centre for lam in scans[0])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_a_limit(tiny_root, cell):
    line = control.readings(harness.Cell(cell, root=tiny_root), 11, True,
                            device="cpu", log=quiet)
    limits = line["limits"]
    assert all(v <= limits[k] for k, v in line["program"].items()), line
    assert any(v > limits[k] for k, v in line["control"].items()), line


def _unchanged(bcd, monkeypatch):
    """Each sweep returns its state unchanged."""
    def loop(sweep_fn, carry, tol, max_iter):
        zero = torch.zeros((), dtype=carry.dtype)
        return orig(lambda c, out: (c, zero, zero + 1), carry, tol, max_iter)
    orig = bcd.converge_loop
    monkeypatch.setattr(bcd, "converge_loop", loop)


def _half_left_out(bcd, monkeypatch):
    """Each sweep updates the first half of the spots only, its statistics
    taken over that half."""
    def loop(sweep_fn, carry, tol, max_iter):
        def half(c, out):
            keep = c.clone()
            new, _, _ = sweep_fn(c, out)
            m = new.shape[-1] // 2
            new[..., m:] = keep[..., m:]
            return (new, torch.amax(torch.abs(new[..., :m] - keep[..., :m])),
                    torch.amax(torch.abs(keep[..., :m])))
        return orig(half, carry, tol, max_iter)
    orig = bcd.converge_loop
    monkeypatch.setattr(bcd, "converge_loop", loop)


def _answer_altered(bcd, monkeypatch):
    """One spot's abundances come out in reverse order of types."""
    import flashdeconv_tpu_torch.core.solver as solver

    def solve(*a, **kw):
        beta, *rest = orig(*a, **kw)
        beta = beta.clone()
        i = beta.shape[0] // 3
        beta[i] = beta[i].flip(0)
        return (beta, *rest)
    orig = solver.fused_solve
    monkeypatch.setattr(solver, "fused_solve", solve)


def _gene_dropped(bcd, monkeypatch):
    """The fit's gene selection loses its last gene."""
    import flashdeconv_tpu_torch.core.deconv as deconv

    def select(*a, **kw):
        genes, lev = orig(*a, **kw)
        return genes[:-1], lev[:-1]
    orig = deconv.select_informative_genes
    monkeypatch.setattr(deconv, "select_informative_genes", select)


def _edge_dropped(bcd, monkeypatch):
    """The fit's graph loses one edge (both directions)."""
    import flashdeconv_tpu_torch.core.deconv as deconv

    def graph(*a, **kw):
        A = orig(*a, **kw).tolil()
        i, j = A.nonzero()[0][0], A.nonzero()[1][0]
        A[i, j] = A[j, i] = 0
        return A.tocsr()
    orig = deconv.coords_to_adjacency
    monkeypatch.setattr(deconv, "coords_to_adjacency", graph)


FAULTS = [(c, f) for c in CELLS
          for f in (_unchanged, _half_left_out, _answer_altered)]
FAULTS += [(c, f) for c in CELLS if c.endswith(".fit")
           for f in (_gene_dropped, _edge_dropped)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault,
                                            monkeypatch):
    import flashdeconv_tpu_torch.ops.bcd as bcd

    fault(bcd, monkeypatch)
    r = run(tiny_root, cell)
    assert not r["correct"], r["compared"]
    if fault in (_gene_dropped, _edge_dropped):
        key = "genes_off" if fault is _gene_dropped else "graph_off"
        assert r["compared"][key]["value"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference_on_the_card(tiny_root, cell,
                                                        card):
    r = harness.run_cell(harness.Cell(cell, root=tiny_root), 5, 0.5, True,
                         device=card, log=quiet)
    assert r["correct"], r["compared"]
    assert r["device"]["busy_s"] > 0
