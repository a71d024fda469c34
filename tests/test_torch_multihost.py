"""The port's multi-process layer against the JAX package's and against its
own single-process mesh, on the CPU.

In this process (one process, no ``torch.distributed`` group) every helper
of ``flashdeconv_tpu_torch.parallel.multihost`` is held against its JAX
counterpart on the same seeded inputs, and ``FlashDeconv.fit_distributed``
against the port's ``fit`` over the same mesh (bitwise) and against the
JAX package's ``fit_distributed`` (``test_sharded_fit_matches_jax``'s
bound: the same lambda and sweeps, proportions within 1e-4).

The jobs are 2 and 4 real processes that form a Gloo group over localhost
and split 8 global CPU shards (``global_spot_mesh(8 // n, "cpu")``), as
``tests/test_multihost_exec.py`` splits 8 virtual devices. Their solves
(banded mesh, fused with and without the overlap split and unfused, also
on shards narrower than its halo, and halo plan, in f32 and f64) must be
bitwise the single-process 8-shard mesh's, with the same sweeps; a 2-process ``fit_distributed`` on CSR
counts with ``log_cpm`` bitwise the single-process ``fit``, pearson and
raw within rtol 1e-9 (the cross-process sums reassociate). A NaN in one
process's statistics must reach every process (``Mesh.join_max`` gathers,
never Gloo's MAX, which drops a NaN). The children refuse to import JAX
and the JAX package, so each job is also a run of the port without them.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flashdeconv_tpu
import flashdeconv_tpu_torch
from flashdeconv_tpu.parallel import multihost as jmh
from flashdeconv_tpu_torch.parallel import multihost as tmh
from flashdeconv_tpu_torch import parallel as tpar
from flashdeconv_tpu_torch.utils.graph import (
    build_grid_graph,
    build_knn_graph,
    build_radius_graph,
)
from torch_multihost_inputs import (
    FIT_CASES,
    FIT_KW,
    SOLVE_KW,
    cuts,
    fit_inputs,
    gene_counts,
    narrow_inputs,
    solve_inputs,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 8
JOB_TIMEOUT = 300


HEADER = r"""
import json, os, sys
import numpy as np

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("flashdeconv_tpu", "bench") or top.startswith("jax"):
            raise ImportError(f"{name} is blocked in this job")

sys.meta_path.insert(0, Refuse())
import torch
torch.set_num_threads(2)
pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
from flashdeconv_tpu_torch.parallel import multihost
multihost.initialize(coordinator_address="localhost:" + port,
                     num_processes=nproc, process_id=pid, backend="gloo")
multihost.initialize()  # idempotent
import torch.distributed as dist
assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
record = {"processes": nproc}
from torch_multihost_inputs import *


def save(name, arr):
    np.save(os.path.join(outdir, f"{name}_p{pid}.npy"), arr)


def finish():
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("flashdeconv_tpu", "bench")
                 or m.startswith("jax"))
    assert not bad, bad
    with open(os.path.join(outdir, f"record_p{pid}.json"), "w") as f:
        json.dump(record, f)
    dist.destroy_process_group()
"""

SOLVE_WORKER = HEADER + r"""
from flashdeconv_tpu_torch.parallel import sharded_bcd_solve
from flashdeconv_tpu_torch.parallel.gspmd import GspmdBandedProblem
from flashdeconv_tpu_torch.utils.graph import build_knn_graph

Y, X, coords = solve_inputs()
A = build_knn_graph(coords, k=4)
mesh = multihost.global_spot_mesh(8 // nproc, device="cpu")
assert len(mesh) == 8 and mesh.spans_processes
assert mesh.local == tuple(range(pid * 8 // nproc, (pid + 1) * 8 // nproc))
for strategy in ("banded", "halo"):
    for dtype in (np.float32, np.float64):
        name = f"{strategy}_{np.dtype(dtype).name}"
        beta, info = sharded_bcd_solve(Y, X, A, coords=coords, mesh=mesh,
                                       strategy=strategy, dtype=dtype,
                                       device="cpu", **SOLVE_KW)
        save(name, beta)
        record[name] = {k: info[k] for k in ("n_shards", "n_iterations",
                                             "final_objective", "converged")}
# The unfused banded mesh on shards narrower than its halo.
Yn, Xn, cn = narrow_inputs()
beta, info = sharded_bcd_solve(Yn, Xn, build_knn_graph(cn, k=4), coords=cn,
                               mesh=mesh, strategy="banded",
                               dtype=np.float64, device="cpu", **SOLVE_KW)
save("banded_narrow", beta)
record["banded_narrow"] = {k: info[k] for k in (
    "n_shards", "n_iterations", "final_objective", "converged")}
# The fused banded mesh on 16-spot blocks: 18 blocks a shard, h = 6 (the
# kNN-4 graph's edges reach two grid rows), so each sweep splits (interior
# calls, pad exchange, boundary calls).
prob = GspmdBandedProblem(Y, X, A, mesh=mesh, fused_block=16, device="cpu")
assert prob.use_fused and prob.n_local // 16 >= 2 * prob._fused_h + 1, (
    prob.n_local, prob._fused_h)
beta, info = prob.solve(**SOLVE_KW)
save("fused_split", beta)
record["fused_split"] = {k: info[k] for k in ("n_iterations",
                                              "final_objective")}
try:
    prob.solve(return_device=True, **SOLVE_KW)
    record["return_device"] = "returned"
except ValueError as e:
    record["return_device"] = str(e)

# A NaN in one process's statistics: Mesh.join_max directly, then a solve
# whose start holds a NaN in the last process's shard only.
stats = [torch.tensor(float(pid)),
         torch.tensor(float("nan") if pid == nproc - 1 else float(pid))]
d, a = mesh.join_max(stats)
record["join_max"] = [float(d), bool(torch.isnan(a))]
beta0 = np.full((Y.shape[0], X.shape[0]), 0.2)
beta0[-1, 0] = np.nan
beta, info = sharded_bcd_solve(Y, X, A, coords=coords, mesh=mesh,
                               strategy="banded", dtype=np.float64,
                               device="cpu", beta_init=beta0, lambda_=0.3,
                               max_iter=5)
save("nan", beta)
record["nan"] = {"n_iterations": info["n_iterations"],
                 "final_change": info["final_change"],
                 "converged": info["converged"]}

# Distributed gene selection over this process's rows.
counts, Xref = gene_counts(Y.shape[0])
c = cuts(Y.shape[0], nproc)
genes, lev = multihost.distributed_select_informative_genes(
    counts[c[pid]:c[pid + 1]], Xref, n_hvg=100, n_markers_per_type=10)
save("genes", genes)
save("leverage", lev)
record["rows"] = multihost.process_row_offsets(int(c[pid + 1] - c[pid]))
finish()
"""

FIT_WORKER = HEADER + r"""
from flashdeconv_tpu_torch import FlashDeconv

Y, X, coords, coords_irr = fit_inputs()
c = cuts(Y.shape[0], nproc)
lo, hi = int(c[pid]), int(c[pid + 1])
for name, kw in FIT_CASES.items():
    cc = coords_irr if name == "irr" else coords
    model = FlashDeconv(n_shards=8 // nproc, **FIT_KW, **kw)
    model.fit_distributed(Y[lo:hi], X, cc[lo:hi])
    save(f"beta_{name}", model.beta_)
    save(f"props_{name}", model.proportions_)
    save(f"genes_{name}", model.gene_idx_)
    record[name] = {
        "rows": list(model.host_rows_), "lambda": model.lambda_used_,
        "n_iterations": model.info_["n_iterations"],
        "final_objective": model.info_["final_objective"],
        "n_shards": model.info_["n_shards"],
        "converged": bool(model.info_["converged"]),
        "adjacency_nnz": int(model.adjacency_.nnz),
    }
finish()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(script: str, nproc: int, outdir: Path) -> list:
    """Run ``script`` as ``nproc`` processes of one Gloo job; returns each
    process's record. Kills every process when one fails or the job
    outlasts ``JOB_TIMEOUT``, so none holds the port."""
    worker = outdir / "worker.py"
    worker.write_text(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p])
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(nproc), port,
             str(outdir)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOB_TIMEOUT))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out}\n{err[-4000:]}"
    return [json.loads((outdir / f"record_p{pid}.json").read_text())
            for pid in range(nproc)]


def load(outdir: Path, name: str, pid: int) -> np.ndarray:
    return np.load(outdir / f"{name}_p{pid}.npy")


CPU8 = ("cpu",) * SHARDS


# -- the helpers in one process, against JAX ----------------------------------

def test_reductions_are_identities_in_one_process():
    a, b = np.arange(5.0), np.ones((2, 3))
    for got, ref in zip(tmh.allreduce_sums(a, b), jmh.allreduce_sums(a, b)):
        np.testing.assert_array_equal(got, ref)
    rows = np.arange(12.0).reshape(4, 3)
    np.testing.assert_array_equal(tmh.allgather_rows(rows),
                                  jmh.allgather_rows(rows))
    assert tmh.allgather_rows(np.zeros((0, 2))).shape == (0, 2)
    assert tmh.process_row_offsets(17) == jmh.process_row_offsets(17) \
        == (0, 17, 17)


def test_initialize_without_a_job_starts_nothing(monkeypatch):
    import torch.distributed as dist

    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    tmh.initialize()
    tmh.initialize(num_processes=1)
    assert not dist.is_initialized()
    mesh = tmh.global_spot_mesh(3, device="cpu")
    assert len(mesh) == 3 and mesh.owners is None
    assert not mesh.spans_processes and mesh.local == (0, 1, 2)
    with pytest.raises(ValueError, match=">= 1"):
        tmh.global_spot_mesh(0, device="cpu")


@pytest.mark.parametrize("pad", [1, 2048])
def test_host_spot_range_matches_jax(pad):
    rng = np.random.RandomState(0)
    coords = rng.rand(1000, 2) * 40
    A = build_knn_graph(coords, k=4)
    plan = tpar.plan_shards(A, SHARDS, coords=coords, pad_shard_to=pad)
    jplan = flashdeconv_tpu.parallel.plan_shards(A, SHARDS, coords=coords,
                                                 pad_shard_to=pad)
    got = tmh.host_spot_range(plan, mesh=tmh.global_spot_mesh(
        SHARDS, device="cpu"))
    assert got == jmh.host_spot_range(jplan) == (0, plan.n_padded)


def test_host_spot_range_rejects_a_wrong_or_interleaved_mesh():
    rng = np.random.RandomState(0)
    coords = rng.rand(200, 2)
    A = build_knn_graph(coords, k=3)
    with pytest.raises(ValueError, match="shards"):
        tmh.host_spot_range(tpar.plan_shards(A, 2, coords=coords),
                            mesh=tpar.Mesh(("cpu",) * 3))
    plan = tpar.plan_shards(A, 4, coords=coords)
    with pytest.raises(ValueError, match="not contiguous"):
        tmh.host_spot_range(plan, mesh=tpar.Mesh(("cpu",) * 4,
                                                 owners=(0, 1, 0, 1)))
    mesh = tpar.Mesh(("cpu",) * 4, owners=(0, 0, 1, 1))
    assert mesh.spans_processes and mesh.local == (0, 1)
    assert tmh.host_spot_range(plan, mesh=mesh) == (0, 2 * plan.shard_size)


@pytest.mark.parametrize("n_shards, owners", [
    (3, (0, 1, 1)),     # ranks own unequal shard counts
    (2, (1, 1)),        # rank 0 (this process) owns none
    (4, (0, 2, 0, 2)),  # rank 1 owns none
    (2, (0,)),          # not one rank a shard
])
def test_mesh_owners_are_checked(n_shards, owners):
    with pytest.raises(ValueError):
        tpar.Mesh(("cpu",) * n_shards, owners=owners)


def test_return_device_is_refused_on_a_mesh_across_processes():
    Y, X, coords = solve_inputs()
    A = build_knn_graph(coords, k=4)
    mesh = tpar.Mesh(("cpu",) * 2, owners=(0, 1))
    for strategy in ("banded", "halo"):
        prob = tpar.prepare_sharded_bcd(Y, X, A, coords=coords, mesh=mesh,
                                        strategy=strategy, device="cpu")
        inner = prob._inner
        ops = inner.Xty_t if strategy == "banded" else inner._ops["Xty_t"]
        # Operands only for this process's shard.
        assert ops[0] is not None and ops[1] is None
        for solver in (prob, inner):
            with pytest.raises(ValueError, match="span processes"):
                solver.solve(return_device=True)


def test_distributed_graphs_match_the_builds():
    _, _, coords, coords_irr = fit_inputs()
    A_d, cg = tmh.distributed_knn_graph(coords_irr, k=5)
    assert (A_d != build_knn_graph(coords_irr, k=5)).nnz == 0
    assert (A_d != jmh.distributed_knn_graph(coords_irr, k=5)[0]).nnz == 0
    np.testing.assert_array_equal(cg, coords_irr)
    A_r, _ = tmh.distributed_adjacency(coords, method="radius", radius=1.2)
    assert (A_r != build_radius_graph(coords, radius=1.2)).nnz == 0
    A_g, _ = tmh.distributed_adjacency(coords, method="grid")
    assert (A_g != build_grid_graph(coords)).nnz == 0
    assert (A_g != jmh.distributed_adjacency(coords, method="grid")[0]
            ).nnz == 0
    with pytest.raises(ValueError, match="radius must be specified"):
        tmh.distributed_adjacency(coords, method="radius")
    with pytest.raises(ValueError, match="Unknown method"):
        tmh.distributed_adjacency(coords, method="voronoi")


@pytest.mark.parametrize("dense", [False, True], ids=["csr", "dense"])
def test_distributed_gene_passes_match_jax(dense):
    Y, X, _, _ = fit_inputs()
    if dense:
        Y = Y.toarray()
    idx = np.arange(0, 400, 7)
    np.testing.assert_array_equal(tmh.distributed_subset_col_mean(Y, idx),
                                  jmh.distributed_subset_col_mean(Y, idx))
    np.testing.assert_allclose(
        tmh.distributed_subset_col_mean(Y, idx),
        np.asarray(Y[:, idx].mean(axis=0)).ravel(), rtol=1e-12)
    for got, ref in zip(tmh.distributed_gene_moments(Y),
                        jmh.distributed_gene_moments(Y)):
        np.testing.assert_array_equal(got, ref)
    got = tmh.distributed_select_informative_genes(
        Y, X, n_hvg=100, n_markers_per_type=10)
    ref = jmh.distributed_select_informative_genes(
        Y, X, n_hvg=100, n_markers_per_type=10)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    if not dense:  # the dense single-process moments are two-pass
        single = flashdeconv_tpu_torch.utils.select_informative_genes(
            Y, X, n_hvg=100, n_markers_per_type=10)
        for g, s in zip(got, single):
            np.testing.assert_array_equal(g, s)


# -- fit_distributed in one process -------------------------------------------

@pytest.fixture(scope="module")
def single_process_fits():
    Y, X, coords, coords_irr = fit_inputs()
    kw = dict(sketch_dim=64, n_hvg=120, n_markers_per_type=10, max_iter=40,
              tol=1e-5, random_state=0)
    out = {}
    for layout, cc in (("grid", coords), ("irregular", coords_irr)):
        port = flashdeconv_tpu_torch.FlashDeconv(device="cpu", n_shards=2,
                                                 **kw)
        port.fit_distributed(Y, X, cc)
        fit = flashdeconv_tpu_torch.FlashDeconv(device="cpu", n_shards=2,
                                                **kw).fit(Y, X, cc)
        ref = flashdeconv_tpu.FlashDeconv(
            mesh=flashdeconv_tpu.parallel.default_mesh(2), **kw)
        ref.fit_distributed(Y, X, cc)
        out[layout] = (port, fit, ref)
    return out


@pytest.mark.parametrize("layout", ["grid", "irregular"])
def test_single_process_fit_distributed_is_bitwise_fit(single_process_fits,
                                                       layout):
    port, fit, _ = single_process_fits[layout]
    assert port._fitted and port.host_rows_ == (0, port.n_spots_)
    assert "_distributed_mesh" not in port.__dict__  # consumed by the solve
    np.testing.assert_array_equal(port.gene_idx_, fit.gene_idx_)
    assert port.lambda_used_ == fit.lambda_used_
    np.testing.assert_array_equal(port.beta_, fit.beta_)
    np.testing.assert_array_equal(port.proportions_, fit.proportions_)
    assert port.info_["n_iterations"] == fit.info_["n_iterations"]
    assert port.info_["final_objective"] == fit.info_["final_objective"]
    assert port.info_["n_shards"] == 2
    assert set(port.timings_) >= {"gene_selection", "sketch",
                                  "spatial_graph", "solve"}


def test_fit_distributed_keeps_xty_on_the_host():
    """While fit_distributed's mesh is pending the fused Xty pass does not
    stream to the device: that Xty is all-gathered on the host."""
    from flashdeconv_tpu_torch import native

    model = flashdeconv_tpu_torch.FlashDeconv(device="cpu")
    model.device = torch.device("cuda")  # the rule alone; nothing runs
    n = native.XTY_STREAM_CHUNK_ROWS + 1
    assert model._streams_xty(n)
    model._distributed_mesh = tpar.Mesh(["cpu"])
    assert not model._streams_xty(n)
    model._clear_consume_once()
    assert model._streams_xty(n)


@pytest.mark.parametrize("layout", ["grid", "irregular"])
def test_single_process_fit_distributed_matches_jax(single_process_fits,
                                                    layout):
    port, _, ref = single_process_fits[layout]
    np.testing.assert_array_equal(port.gene_idx_, ref.gene_idx_)
    assert port.lambda_used_ == ref.lambda_used_
    assert port.info_["n_iterations"] == ref.info_["n_iterations"]
    assert port.host_rows_ == ref.host_rows_
    np.testing.assert_allclose(port.proportions_, ref.proportions_,
                               atol=1e-4)


# -- jobs of 2 and 4 processes ------------------------------------------------

@pytest.fixture(scope="module", params=[2, 4], ids=["2proc", "4proc"])
def solve_job(request, tmp_path_factory):
    outdir = tmp_path_factory.mktemp(f"solve{request.param}")
    return request.param, outdir, run_job(SOLVE_WORKER, request.param,
                                          outdir)


@pytest.fixture(scope="module")
def solve_refs():
    from flashdeconv_tpu_torch.parallel import sharded_bcd_solve
    from flashdeconv_tpu_torch.parallel.gspmd import GspmdBandedProblem

    Y, X, coords = solve_inputs()
    A = build_knn_graph(coords, k=4)
    refs = {}
    for strategy in ("banded", "halo"):
        for dtype in (np.float32, np.float64):
            refs[f"{strategy}_{np.dtype(dtype).name}"] = sharded_bcd_solve(
                Y, X, A, coords=coords, mesh=CPU8, strategy=strategy,
                dtype=dtype, device="cpu", **SOLVE_KW)
    Yn, Xn, cn = narrow_inputs()
    refs["banded_narrow"] = sharded_bcd_solve(
        Yn, Xn, build_knn_graph(cn, k=4), coords=cn, mesh=CPU8,
        strategy="banded", dtype=np.float64, device="cpu", **SOLVE_KW)
    refs["fused_split"] = GspmdBandedProblem(
        Y, X, A, mesh=CPU8, fused_block=16, device="cpu").solve(**SOLVE_KW)
    beta0 = np.full((Y.shape[0], X.shape[0]), 0.2)
    beta0[-1, 0] = np.nan
    refs["nan"] = sharded_bcd_solve(
        Y, X, A, coords=coords, mesh=CPU8, strategy="banded",
        dtype=np.float64, device="cpu", beta_init=beta0, lambda_=0.3,
        max_iter=5)
    return refs


@pytest.mark.parametrize("name", ["banded_float32", "banded_float64",
                                  "halo_float32", "halo_float64",
                                  "banded_narrow", "fused_split"])
def test_multi_process_solve_is_bitwise_one_process(solve_job, solve_refs,
                                                    name):
    nproc, outdir, records = solve_job
    beta_ref, info_ref = solve_refs[name]
    for pid in range(nproc):
        np.testing.assert_array_equal(load(outdir, name, pid), beta_ref)
        rec = records[pid][name]
        assert rec["n_iterations"] == info_ref["n_iterations"]
        # The objective's shard sums are added in shard order everywhere.
        assert rec["final_objective"] == info_ref["final_objective"]
        assert rec.get("n_shards", SHARDS) == SHARDS


def test_multi_process_mesh_refuses_return_device(solve_job):
    _, _, records = solve_job
    assert all("span processes" in r["return_device"] for r in records)


def test_nan_in_one_process_reaches_every_process(solve_job, solve_refs):
    """Gloo's all_reduce(MAX) drops a NaN; the mesh gathers the statistics
    and takes torch.amax, so every process sees it, as in one process."""
    nproc, outdir, records = solve_job
    beta_ref, info_ref = solve_refs["nan"]
    assert np.isnan(info_ref["final_change"])
    for pid in range(nproc):
        assert records[pid]["join_max"] == [float(nproc - 1), True]
        rec = records[pid]["nan"]
        assert rec["n_iterations"] == info_ref["n_iterations"]
        assert np.isnan(rec["final_change"]) and not rec["converged"]
        np.testing.assert_array_equal(load(outdir, "nan", pid), beta_ref)


def test_multi_process_gene_selection_is_the_single_process_one(solve_job):
    nproc, outdir, records = solve_job
    counts, Xref = gene_counts(solve_inputs()[0].shape[0])
    idx, lev = flashdeconv_tpu_torch.utils.select_informative_genes(
        counts, Xref, n_hvg=100, n_markers_per_type=10)
    c = cuts(counts.shape[0], nproc)
    for pid in range(nproc):
        np.testing.assert_array_equal(load(outdir, "genes", pid), idx)
        np.testing.assert_allclose(load(outdir, "leverage", pid), lev,
                                   rtol=1e-12)
        assert records[pid]["rows"] == [int(c[pid]), int(c[pid + 1]),
                                        counts.shape[0]]


@pytest.fixture(scope="module")
def fit_job(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("fit2")
    return 2, outdir, run_job(FIT_WORKER, 2, outdir)


@pytest.mark.parametrize("name", list(FIT_CASES))
def test_two_process_fit_distributed_matches_fit(fit_job, name):
    nproc, outdir, records = fit_job
    Y, X, coords, coords_irr = fit_inputs()
    ref = flashdeconv_tpu_torch.FlashDeconv(
        n_shards=SHARDS, **FIT_KW, **FIT_CASES[name]).fit(
        Y, X, coords_irr if name == "irr" else coords)
    c = cuts(Y.shape[0], nproc)
    assert c[1] != Y.shape[0] // 2
    for pid in range(nproc):
        rec = records[pid][name]
        assert rec["rows"] == [int(c[pid]), int(c[pid + 1])]
        np.testing.assert_array_equal(load(outdir, f"genes_{name}", pid),
                                      ref.gene_idx_)
        assert rec["n_shards"] == SHARDS
        assert rec["n_iterations"] == ref.info_["n_iterations"]
        assert rec["converged"] == ref.info_["converged"]
        assert rec["adjacency_nnz"] == ref.adjacency_.nnz
        beta = load(outdir, f"beta_{name}", pid)
        props = load(outdir, f"props_{name}", pid)
        if name in ("pearson", "raw"):
            np.testing.assert_allclose(beta, ref.beta_, rtol=1e-9,
                                       atol=1e-12)
            assert rec["lambda"] == pytest.approx(ref.lambda_used_,
                                                  rel=1e-12)
        else:
            # CSR counts + log_cpm: the native pass is row-local and the
            # rows are gathered in order, so beta is the same bits.
            np.testing.assert_array_equal(beta, ref.beta_)
            np.testing.assert_array_equal(props, ref.proportions_)
            assert rec["lambda"] == ref.lambda_used_
        # YtY is a cross-process sum (reassociated).
        assert rec["final_objective"] == pytest.approx(
            ref.info_["final_objective"], rel=1e-9)
