"""The port runs with neither JAX nor the JAX package, as on the card's
machine.

A fresh interpreter whose import system refuses the top-level modules
``flashdeconv_tpu``, ``bench`` and every ``jax*`` imports
``flashdeconv_tpu_torch`` and solves one gather-tier problem (irregular
coordinates) and one fused-tier problem (a 96 x 96 grid) on the CPU, and
two spot-sharded solves on a mesh of two CPU shards (``parallel/``: the
banded mesh and the halo plan), ``fit_distributed`` on a 2-shard
``global_spot_mesh`` without a process group (``parallel/multihost.py``;
tests/test_torch_multihost.py runs it in jobs of 2 and 4 processes that
refuse the same imports), two solves on the XLA tier (an f64 grid
and a K = 385 gather problem, the first K above the kernels'; it was 257
while they stopped at 256), then imports ``chip_smoke.py`` and fits
its dense counts through the dense sketch route (``ops/countsketch.py``),
runs ``tl.deconvolve`` (``tl/`` and ``io/``) on those counts through
tests/fake_anndata.py, imports every name the subpackages export and draws
the fit with ``pl/`` on the Agg backend. A static check holds every module
of the port, ``parallel/``, ``tl/``, ``io/`` and ``pl/`` among them, and
``chip_smoke.py`` and tests/test_torch_multicard.py (run on the cards
with ``--noconftest``), to the same rule.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REFUSED = ("flashdeconv_tpu", "bench", "jax")

CHILD = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("flashdeconv_tpu", "bench") or top.startswith("jax"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, Refuse())

import numpy as np
import torch

torch.set_num_threads(2)
from flashdeconv_tpu_torch.core.solver import prepare_bcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph, grid_coords

rng = np.random.default_rng(0)
X = rng.standard_normal((8, 64))
for coords, tier in ((rng.random((2000, 2)) * 45, "GatherTier"),
                     (grid_coords(side=96), "FusedBandedTier")):
    beta_true = rng.dirichlet(np.ones(8), size=coords.shape[0])
    Y = beta_true @ X + 0.05 * rng.standard_normal((coords.shape[0], 64))
    prob = prepare_bcd(Y, X, build_knn_graph(coords, k=6), coords=coords,
                       device="cpu")
    assert type(prob.tier).__name__ == tier, type(prob.tier)
    beta, info = prob.solve()
    assert info["converged"] and np.isfinite(beta).all() and (beta >= 0).all()
    print(tier, info["n_iterations"])

# The spot-sharded solves on a mesh of CPU shards: the banded mesh (grid)
# and the halo plan (irregular coordinates).
from flashdeconv_tpu_torch.parallel import sharded_bcd_solve

for coords, strategy in ((grid_coords(side=40), "banded"),
                         (rng.random((900, 2)) * 30, "halo")):
    Y = rng.dirichlet(np.ones(8), size=coords.shape[0]) @ X
    beta, info = sharded_bcd_solve(
        Y, X, build_knn_graph(coords, k=6), coords=coords,
        mesh=("cpu",) * 2, strategy=strategy, device="cpu")
    assert info["converged"] and info["n_shards"] == 2, info
    assert np.isfinite(beta).all() and (beta >= 0).all()
    print(strategy, info["n_iterations"])

# The multi-process layer without a process group: a 2-shard mesh of this
# process, and fit_distributed, which is then the sharded fit.
from scipy import sparse
from flashdeconv_tpu_torch import FlashDeconv
from flashdeconv_tpu_torch.parallel import multihost

multihost.initialize()
mesh = multihost.global_spot_mesh(2, device="cpu")
coords = grid_coords(side=20)
counts = sparse.csr_matrix(rng.poisson(
    rng.dirichlet(np.ones(8), size=coords.shape[0]) @ np.abs(X) * 20.0
).astype(np.float64))
model = FlashDeconv(device="cpu", mesh=mesh, sketch_dim=32, n_hvg=40,
                    n_markers_per_type=4)
model.fit_distributed(counts, np.abs(X), coords)
assert model.host_rows_ == (0, 400) and model.info_["n_shards"] == 2
print("multihost", model.info_["n_iterations"])

# The XLA tier: f64 on a grid (the unfused banded form) and K above the
# kernels' on an irregular graph (the gather form).
from flashdeconv_tpu_torch.ops.bcd import KERNEL_MAX_K

for coords, K, dtype, tier in ((grid_coords(side=96), 8, np.float64,
                                "BandedTier"),
                               (rng.random((300, 2)) * 17, KERNEL_MAX_K + 1,
                                np.float32, "GatherTier")):
    Xk = rng.standard_normal((K, K + 32))
    Y = rng.dirichlet(np.ones(K), size=coords.shape[0]) @ Xk
    prob = prepare_bcd(Y, Xk, build_knn_graph(coords, k=6), coords=coords,
                       dtype=dtype, device="cpu")
    assert type(prob.tier).__name__ == tier and not prob.tier.uses_kernel
    beta, info = prob.solve(max_iter=30)
    assert np.isfinite(beta).all() and (beta >= 0).all()
    print(tier, np.dtype(dtype).name, info["n_iterations"])

# The dense-count route: chip_smoke's dense counts, projected through the
# device route (forced on the CPU, where it runs the plain versions).
import chip_smoke
import flashdeconv_tpu_torch.core.sketching as sk
from flashdeconv_tpu_torch import FlashDeconv
from flashdeconv_tpu_torch.ops import countsketch

coords = chip_smoke.irregular_coords(1500)
Y, X, truth = chip_smoke.synthetic_counts(coords, 38.0, 300, 6, dense=True)
assert isinstance(Y, np.ndarray) and Y.shape == (1500, 300)
sk._device_projection_available = lambda device: True
props = FlashDeconv(device="cpu", n_hvg=300).fit_transform(Y, X, coords)
assert props.shape == (1500, 6) and np.isfinite(props).all()
assert "countsketch_project_kernel" in dir(countsketch)
print("dense", props.shape)

# The AnnData layer: tl.deconvolve on the duck-typed stand-in of
# tests/fake_anndata.py (pandas only).
import flashdeconv_tpu_torch as fdt
from fake_anndata import make_reference_adata, make_spatial_adata

genes = [f"g{i}" for i in range(300)]
st = make_spatial_adata(Y, coords, gene_names=genes)
cells = np.vstack([rng.poisson(X[k] / X[k].sum() * 1500, size=(10, 300))
                   for k in range(6)]).astype(float)
ref = make_reference_adata(cells, np.repeat([f"t{k}" for k in range(6)], 10),
                           gene_names=genes)
fdt.tl.deconvolve(st, ref, n_hvg=300, device="cpu")
P = np.asarray(st.obsm["flashdeconv"])
assert P.shape == (1500, 6) and np.allclose(P.sum(axis=1), 1.0)
print("tl", P.shape, fdt.__version__)

# The subpackages' exports, and the plots of that fit.
import matplotlib
matplotlib.use("Agg")
import flashdeconv_tpu_torch.core
import flashdeconv_tpu_torch.ops
import flashdeconv_tpu_torch.utils

for pkg in (fdt, fdt.core, fdt.ops, fdt.utils, fdt.pl):
    for name in pkg.__all__:
        getattr(pkg, name)
ax = fdt.pl.spatial(st, color="dominant")
assert sum(len(c.get_offsets()) for c in ax.collections) == 1500
assert len(fdt.pl.composition(st).patches) == 6
print("pl", len(ax.collections))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("flashdeconv_tpu", "bench")
             or m.startswith("jax"))
assert not bad, bad
print("NOJAX_OK")
"""


def test_port_imports_and_solves_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]
        + [p for p in [env.get("PYTHONPATH")] if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "flashdeconv_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "test_torch_multicard.py")
    assert len(files) > 10
    assert ROOT / "flashdeconv_tpu_torch" / "ops" / "countsketch.py" in files
    assert ROOT / "flashdeconv_tpu_torch" / "parallel" / "gspmd.py" in files
    assert ROOT / "flashdeconv_tpu_torch" / "parallel" / "multihost.py" in files
    for module in ("timing.py", "hostmem.py"):
        assert ROOT / "flashdeconv_tpu_torch" / "utils" / module in files
    for module in ("tl/_deconvolve.py", "tl/__init__.py", "io/loader.py",
                   "io/__init__.py", "pl/_plots.py", "pl/__init__.py"):
        assert ROOT / "flashdeconv_tpu_torch" / module in files
    found = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files for name in _imported_modules(path)
        if name.split(".")[0] in REFUSED or name.startswith("jax")
    ]
    assert not found, found
