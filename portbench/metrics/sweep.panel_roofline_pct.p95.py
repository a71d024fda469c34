"""``sweep.panel_roofline_pct`` (kernel #1's panel pass at its roofline,
%) in a cell that reports ``solve_ms_p95`` and not ``solve_spots_per_s``:
the same reader, split by the end-to-end metric it moves."""

from pathlib import Path

from portbench.harness import load_module

_PANEL = load_module(Path(__file__).with_name("sweep.panel_roofline_pct.py"))


def read(run):
    return _PANEL.read(run)
