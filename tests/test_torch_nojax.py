"""The port runs with JAX absent, as on the card's machine.

A fresh interpreter whose import system refuses every ``jax*`` module
imports ``flashdeconv_tpu_torch`` and runs a 96 x 96 grid ``bcd_solve`` on
the CPU. The variable that keeps ``flashdeconv_tpu``'s package init away
from JAX is removed from the child's environment, so the port must set it
itself.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, RefuseJax())

import numpy as np
import torch

torch.set_num_threads(2)
import flashdeconv_tpu_torch
from flashdeconv_tpu_torch.core.solver import bcd_solve
from flashdeconv_tpu.utils.graph import build_knn_graph
from bench import make_problem

Y, X, coords = make_problem(96 * 96, 8, 64)
beta, info = bcd_solve(Y, X, build_knn_graph(coords, k=6), coords=coords,
                       device="cpu")
assert info["converged"] and np.isfinite(beta).all() and (beta >= 0).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NOJAX_OK", info["n_iterations"])
"""


def test_port_imports_and_solves_without_jax():
    env = {k: v for k, v in os.environ.items()
           if k != "FLASHDECONV_NO_COMPILE_CACHE"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p]
    )
    proc = subprocess.run(
        [sys.executable, "-c", CHILD], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
