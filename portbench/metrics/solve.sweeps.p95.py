"""``solve.sweeps`` (mean sweeps a solve) in a cell that reports
``solve_ms_p95`` and not ``solve_spots_per_s``: the same reader, split by
the end-to-end metric it moves."""

from pathlib import Path

from portbench.harness import load_module

_SOLVE_SWEEPS = load_module(Path(__file__).with_name("solve.sweeps.py"))


def read(run):
    return _SOLVE_SWEEPS.read(run)
