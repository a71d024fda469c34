"""The port runs with neither JAX nor the JAX package, as on the card's
machine.

A fresh interpreter whose import system refuses the top-level modules
``flashdeconv_tpu``, ``bench`` and every ``jax*`` imports
``flashdeconv_tpu_torch`` and solves one gather-tier problem (irregular
coordinates) and one fused-tier problem (a 96 x 96 grid) on the CPU, then
imports ``chip_smoke.py`` and fits its dense counts through the dense
sketch route (``ops/countsketch.py``). A static check holds every module
of the port, and ``chip_smoke.py``, to the same rule.
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("flashdeconv_tpu", "bench")
             or m.startswith("jax"))
assert not bad, bad
print("NOJAX_OK")
"""


def test_port_imports_and_solves_without_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
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
    assert len(files) > 10
    assert ROOT / "flashdeconv_tpu_torch" / "ops" / "countsketch.py" in files
    found = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files for name in _imported_modules(path)
        if name.split(".")[0] in REFUSED or name.startswith("jax")
    ]
    assert not found, found
