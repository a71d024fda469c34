"""The port's package namespaces against the JAX package's, and the host
functions behind them.

Every module-level function and class of every JAX module resolves on the
port's module of the same path, or stands in ``COUNTERPARTS`` with the port
name that does its job (the TPU-only mechanics: Pallas kernels, VMEM
budgets, one-program solves, ``shard_map`` programs, the JAX key bridge).

Every name in the ``__all__`` of ``flashdeconv_tpu``, ``flashdeconv_tpu.core``,
``.ops`` and ``.utils`` resolves on the port's counterpart, from the port's
module of the same name (``utils.as_jax_key`` excepted: its counterpart is
``utils.as_torch_generator``). The host functions the port copied for
those names are held bit for bit against their originals, as
tests/test_torch_host.py holds the other copies; the device
``soft_threshold`` against the JAX one.
"""

import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import sparse

import flashdeconv_tpu
import flashdeconv_tpu.core.solver as j_solver
import flashdeconv_tpu.core.spatial as j_spatial
import flashdeconv_tpu.ops.bcd as j_bcd
import flashdeconv_tpu.utils.graph as j_graph
import flashdeconv_tpu_torch
import flashdeconv_tpu_torch.core.solver as t_solver
import flashdeconv_tpu_torch.core.spatial as t_spatial
import flashdeconv_tpu_torch.ops.bcd as t_bcd
import flashdeconv_tpu_torch.utils.graph as t_graph
from flashdeconv_tpu_torch.utils.random import as_torch_generator
from test_torch_host import _assert_same

SUBPACKAGES = ("", ".core", ".ops", ".utils")
# The one JAX name whose counterpart has a torch name, and its counterpart.
RENAMED = {"as_jax_key": "as_torch_generator"}


def _packages(sub):
    return (importlib.import_module("flashdeconv_tpu" + sub),
            importlib.import_module("flashdeconv_tpu_torch" + sub))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_resolves_on_the_port(sub):
    jpkg, tpkg = _packages(sub)
    missing = [RENAMED.get(n, n) for n in jpkg.__all__
               if not hasattr(tpkg, RENAMED.get(n, n))]
    assert not missing, missing
    assert set(RENAMED.get(n, n) for n in jpkg.__all__) <= set(tpkg.__all__)
    for name in tpkg.__all__:
        obj = getattr(tpkg, name)
        if callable(obj):
            assert obj.__module__.startswith("flashdeconv_tpu_torch."), name


_PORT = "flashdeconv_tpu_torch"
# The JAX names with no port name of their own: (JAX module, name) -> the
# port's "module:attribute" that does its job.
COUNTERPARTS = {
    # XLA's persistent compile cache: the kernels' content-hashed build.
    ("flashdeconv_tpu", "_setup_compilation_cache"):
        f"{_PORT}.ops._build:build",
    # The host-side guard of Xty's non-finite rows: the meshes' copy (the
    # single-device tiers guard on the device, in BCDProblem).
    ("flashdeconv_tpu.core.solver", "sanitize_xty_rows"):
        f"{_PORT}.parallel._runner:sanitize_xty_rows",
    # The Pallas kernels and their wrappers: the CUDA kernels
    # (ops/csrc/*.cu) and the wrappers that launch them.
    ("flashdeconv_tpu.ops.bcd", "_make_fused_banded_kernel"):
        f"{_PORT}.ops.bcd:fused_banded_sweep",
    ("flashdeconv_tpu.ops.bcd", "_cd_block_kernel"):
        f"{_PORT}.ops.bcd:coordinate_descent_block",
    ("flashdeconv_tpu.ops.bcd", "coordinate_descent_pallas"):
        f"{_PORT}.ops.bcd:coordinate_descent_block",
    ("flashdeconv_tpu.ops.countsketch", "_countsketch_kernel"):
        f"{_PORT}.ops.countsketch:countsketch_project_kernel",
    ("flashdeconv_tpu.ops.countsketch", "countsketch_project_pallas"):
        f"{_PORT}.ops.countsketch:countsketch_project_kernel",
    # VMEM budgets and lane rounding: the fused tier's plan is h for its
    # fixed block, or no fused tier; the launch's grid and shared memory
    # come from the C entry; the CountSketch kernel's gate is the shape.
    ("flashdeconv_tpu.ops.bcd", "plan_fused_banded"):
        f"{_PORT}.core.solver:fused_decomposition",
    ("flashdeconv_tpu.ops.bcd", "fused_banded_vmem_bytes"):
        f"{_PORT}.ops.bcd:fused_sweep_launch",
    ("flashdeconv_tpu.ops.countsketch", "_pallas_project_vmem_bytes"):
        f"{_PORT}.ops.countsketch:kernel_route",
    ("flashdeconv_tpu.ops.countsketch", "_round_up"):
        f"{_PORT}.ops.countsketch:kernel_route",
    # The one-program solves: the one solve of every tier; the chunked
    # verbose loop: the one chunked solve loop of every tier and mesh.
    ("flashdeconv_tpu.ops.bcd", "fused_solve_program"):
        f"{_PORT}.ops.bcd:fused_solve",
    ("flashdeconv_tpu.ops.bcd", "solve_program"):
        f"{_PORT}.ops.bcd:fused_solve",
    ("flashdeconv_tpu.ops.bcd", "chunked_verbose_solve"):
        f"{_PORT}.ops.bcd:run_prepared_solve",
    # shard_map programs and sharded placement: per-shard work on the Mesh.
    ("flashdeconv_tpu.parallel._runner", "put_addressable"):
        f"{_PORT}.parallel._runner:Mesh.per_shard",
    ("flashdeconv_tpu.parallel.solver", "_sharded_iterate"):
        f"{_PORT}.parallel.solver:_sharded_sweep",
    ("flashdeconv_tpu.parallel.solver", "_sharded_solve_jit"):
        f"{_PORT}.parallel.solver:HaloShardedProblem",
    # The mesh objective's reduction: the one of both meshes.
    ("flashdeconv_tpu.parallel.solver", "_sharded_objective"):
        f"{_PORT}.parallel._runner:MeshProblem._objective",
    ("flashdeconv_tpu.parallel.solver", "_sharded_objective_jit"):
        f"{_PORT}.parallel._runner:MeshProblem._objective",
    # The JAX key bridge.
    ("flashdeconv_tpu.utils.random", "as_jax_key"):
        f"{_PORT}.utils.random:as_torch_generator",
}


def _jax_modules():
    root = Path(flashdeconv_tpu.__file__).resolve().parent
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _resolve(target: str):
    module, attr = target.split(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def test_every_jax_function_and_class_has_a_port_counterpart():
    """A JAX module-level function or class resolves on the port module of
    the same path or is in ``COUNTERPARTS``, whose targets resolve; an
    entry for a name the port has, or for no JAX name, fails too."""
    missing, mapped = [], set()
    for module, path in _jax_modules():
        port = importlib.import_module(_PORT + module[len("flashdeconv_tpu"):])
        for node in ast.parse(path.read_text()).body:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                continue
            key = (module, node.name)
            if hasattr(port, node.name):
                assert key not in COUNTERPARTS, f"stale entry {key}"
            elif key in COUNTERPARTS:
                _resolve(COUNTERPARTS[key])
                mapped.add(key)
            else:
                missing.append(key)
    assert not missing, missing
    assert mapped == set(COUNTERPARTS)


def test_the_documented_imports_work():
    from flashdeconv_tpu_torch.core import (  # noqa: F401
        BCDProblem, GraphDecomposition, bcd_solve, prepare_bcd)
    from flashdeconv_tpu_torch.ops import (  # noqa: F401
        bcd_iterate, bcd_sweep, coordinate_descent, objective_terms)
    from flashdeconv_tpu_torch.utils import (  # noqa: F401
        build_grid_graph, compute_rmse, select_hvg)

    assert "pl" in flashdeconv_tpu_torch.__all__
    assert flashdeconv_tpu_torch.pl.__all__ == flashdeconv_tpu.pl.__all__
    assert t_solver.bcd_solve is flashdeconv_tpu_torch.core.bcd_solve


A_KNN = j_graph.build_knn_graph(
    np.random.RandomState(3).rand(400, 2) * 20, k=6)
BETA = np.abs(np.random.RandomState(7).randn(400, 5))
SKETCH_Y = np.random.RandomState(5).randn(400, 32)
SKETCH_X = np.random.RandomState(6).randn(5, 32)


def _objective(m):
    H = m.solver.precompute_XtY(SKETCH_X, SKETCH_Y)
    L = m.spatial.compute_laplacian(A_KNN)
    return m.solver.compute_objective(
        BETA, H, SKETCH_X @ SKETCH_X.T, 7.5, L, 0.3, 0.02)


JAX_PKG = type("M", (), dict(solver=j_solver, spatial=j_spatial,
                             graph=j_graph))
PORT = type("M", (), dict(solver=t_solver, spatial=t_spatial,
                          graph=t_graph))

CASES = {
    "solver_soft_threshold": lambda m: [
        m.solver.soft_threshold(x, 0.5) for x in (-2.0, -0.5, 0.1, 0.5, 3.0)],
    "solver_precompute_xty": lambda m: m.solver.precompute_XtY(
        SKETCH_X, SKETCH_Y),
    "solver_compute_objective": _objective,
    "spatial_degree_matrix": lambda m: m.spatial.compute_degree_matrix(
        A_KNN),
    "spatial_laplacian": lambda m: m.spatial.compute_laplacian(A_KNN),
    "spatial_laplacian_normalized": lambda m: m.spatial.compute_laplacian(
        sparse.csr_matrix(A_KNN.toarray() * np.linspace(0.5, 2, 400)),
        normalized=True),
    "spatial_laplacian_quadratic": lambda m:
        m.spatial.compute_laplacian_quadratic(
            BETA, m.spatial.compute_laplacian(A_KNN)),
    "spatial_neighbor_counts": lambda m: m.spatial.get_neighbor_counts(
        A_KNN),
    "spatial_neighbor_indices": lambda m: m.spatial.get_neighbor_indices(
        A_KNN),
    "graph_neighbor_counts": lambda m: m.graph.get_neighbor_counts(A_KNN),
    "graph_neighbor_indices": lambda m: m.graph.get_neighbor_indices(A_KNN),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_original(case):
    _assert_same(CASES[case](JAX_PKG), CASES[case](PORT))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_soft_threshold_matches_jax(dtype):
    x = (np.random.RandomState(1).randn(257) * 2).astype(dtype)
    x[:3] = [0.0, 0.5, -0.5]
    ref = np.asarray(j_bcd.soft_threshold(jnp.asarray(x), 0.5))
    got = t_bcd.soft_threshold(torch.from_numpy(x), 0.5).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_torch_generator_follows_the_seed_rule():
    """An int seeds the generator itself; a RandomState hands over its next
    draw (as ``as_jax_key`` seeds its key)."""
    a = torch.rand(4, generator=as_torch_generator(7))
    assert torch.equal(a, torch.rand(4, generator=as_torch_generator(7)))
    assert as_torch_generator(np.int64(7)).initial_seed() == 7
    seed = np.random.RandomState(3).randint(0, 2**31 - 1)
    gen = as_torch_generator(np.random.RandomState(3))
    assert gen.initial_seed() == seed
