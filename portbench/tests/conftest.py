"""Fixtures of the benchmark's own tests (``python -m pytest
portbench/tests``): a copy of the benchmark whose configurations are cut
to a size the CPU runs in seconds, with the cells, traffic mixes, limits
and metrics of the real one."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from portbench import inputs

REPO = Path(__file__).resolve().parents[2]

#: Tiny stand-ins of the configurations: each keeps its layout's kind,
#: the counts' recipe and the fit's settings, at a size the CPU solves in
#: milliseconds (the grid still takes the fused tier: 9,216 bins).
TINY = {
    "stereoseq_bin20_k20": dict(layout=dict(kind="grid", side=96),
                                n_bins=96 * 96, n_types=4, sketch_dim=32),
    "vhd8um_tissue_k20": dict(
        layout=dict(kind="tissue", side=120, radius_share=0.45,
                    holes=[[40, 50, 4], [70, 80, 3]]),
        n_types=4, n_genes=600, sketch_dim=32),
}


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg.update(TINY[cfg["name"]])
    cfg["n_bins"] = int(inputs.layout_coords(cfg["layout"]).shape[0])
    if "counts" in cfg:
        cfg["counts"].update(markers_per_type=10, chunk_rows=1000)
        cfg["fit"].update(sketch_dim=32, n_hvg=100, n_markers_per_type=10)
    return cfg


def copy_benchmark(dest: Path, tiny: bool) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``dest``, the
    configurations cut to :data:`TINY` with ``tiny``."""
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    if tiny:
        spec = json.loads((dest / "BENCHMARK.json").read_text())
        for entry in spec["configs"]:
            path = dest / entry["file"]
            path.write_text(json.dumps(tiny_config(json.loads(
                path.read_text()))))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return copy_benchmark(tmp_path_factory.mktemp("tiny"), tiny=True)


@pytest.fixture
def card():
    """Skips a test that needs an NVIDIA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return "cuda"
