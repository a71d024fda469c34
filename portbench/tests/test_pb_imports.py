"""Nothing under ``portbench/`` imports JAX or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
whole top-level name, the part before the first dot: the port's name,
``flashdeconv_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from portbench.tests.conftest import REPO

PB = REPO / "portbench"
BANNED = {"jax", "jaxlib", "flax", "flashdeconv_tpu", "bench", "benchmarks"}
PORT = "flashdeconv_tpu_torch"


def top_level_imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_whole_names_are_compared(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import flashdeconv_tpu_torch.core\nfrom jax import numpy\n")
    tops = top_level_imports(p)
    assert tops == {PORT, "jax"} and not ({PORT} & BANNED)
    assert "flashdeconv_tpu" not in tops


def test_no_file_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not (top_level_imports(path) & BANNED), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (PB / "reference").rglob("*.py"):
        assert PORT not in top_level_imports(path), path


CHILD = r"""
import importlib.abc, json, sys
BANNED = set(json.loads(sys.argv[1]))
REF_ONLY = sys.argv[2] == "reference"

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in BANNED or (REF_ONLY and top == "flashdeconv_tpu_torch"):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
import pkgutil, importlib
import portbench
if REF_ONLY:
    import portbench.reference.solve, portbench.reference.fit
else:
    for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
        if ".tests" not in m.name and not m.name.startswith(
                "portbench.metrics."):
            importlib.import_module(m.name)
    import portbench.harness as h
    from pathlib import Path
    for p in sorted((Path(portbench.__file__).parent).rglob("*.py")):
        if p.parent.name in ("metrics", "loops"):
            h.load_module(p)
    import flashdeconv_tpu_torch
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.core.solver import prepare_bcd
tops = {m.split(".")[0] for m in sys.modules}
print(json.dumps(sorted(tops & BANNED)))
"""


def _child(which):
    return subprocess.run(
        [sys.executable, "-c", CHILD, json.dumps(sorted(BANNED)), which],
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_a_child_that_refuses_jax_imports_the_benchmark_and_the_port():
    proc = _child("all")
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_a_child_that_refuses_the_port_imports_the_reference():
    proc = _child("reference")
    assert proc.returncode == 0, proc.stderr
