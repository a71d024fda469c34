"""Tiny stand-ins of the configurations that ``portbench/tests/conftest.py``
does not list, registered before its fixtures cut the benchmark's copy to
size: each keeps its layout's kind and its number of types, at a size the
CPU solves in well under a second (the grid still takes the fused tier:
9,216 bins)."""

from portbench.tests import conftest as tests_conftest

tests_conftest.TINY.setdefault(
    "stereoseq_bin20_k34",
    dict(layout=dict(kind="grid", side=96), n_bins=96 * 96, n_types=34,
         sketch_dim=64))
