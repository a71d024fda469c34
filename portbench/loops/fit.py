"""Whole fits of one section: ``FlashDeconv(**fit).fit(Y, X, coords)`` on
host CSR counts, one after another, with the default outputs (proportions
normalised on the card and fetched to the host).

Set-up makes the signatures from the seed on the host and the counts from
the seed on the card (in row chunks, copied to the host as CSR), and fits
once to warm up. The check works the whole fit out again with the plain
reference (gene selection, preprocessing, sketch, graph, lambda, solve,
normalisation) and compares each part that the program reports.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import inputs
from portbench.reference import fit as ref_fit
from portbench.reference import solve as ref_solve


def build(log) -> None:
    """Builds (in a fresh checkout) and loads the program's CUDA kernels and
    its native host kernels."""
    from flashdeconv_tpu_torch import native
    from flashdeconv_tpu_torch.ops import _build

    _build.build()
    if not native.available():
        log("the native host kernels did not build: the fit takes its "
            "NumPy paths")


def setup(cfg: dict, traffic: dict, seed: int, device, log) -> dict:
    from flashdeconv_tpu_torch import FlashDeconv

    t = time.perf_counter()
    coords = inputs.layout_coords(cfg["layout"])
    if coords.shape[0] != int(cfg["n_bins"]):
        raise ValueError(f"layout gives {coords.shape[0]} bins, the "
                         f"configuration states {cfg['n_bins']}")
    X = inputs.signatures(cfg)
    Y = inputs.counts(cfg, coords, X, seed, device)
    nbytes = Y.data.nbytes + Y.indices.nbytes + Y.indptr.nbytes
    log(f"inputs: {Y.shape[0]} bins x {Y.shape[1]} genes, nnz {Y.nnz}, "
        f"CSR {nbytes} B ({Y.data.dtype} data), signatures {X.shape} in "
        f"{time.perf_counter() - t:.3f} s")
    state = dict(cfg=cfg, traffic=traffic, Y=Y, X=X, coords=coords,
                 program=lambda: FlashDeconv(device=device, **cfg["fit"]),
                 work=dict(n_spots=Y.shape[0], n_types=X.shape[0],
                           n_genes=Y.shape[1], nnz=int(Y.nnz)))
    t = time.perf_counter()
    rec = run_one(state)
    log(f"warm-up fit {time.perf_counter() - t:.3f} s, stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["timings"].items()))
    return state


def run_one(state: dict) -> dict:
    model = state["program"]()
    model.fit(state["Y"], state["X"], state["coords"])
    return dict(spots=state["work"]["n_spots"],
                sweeps=int(model.info_["n_iterations"]),
                timings=dict(model.timings_),
                output=dict(proportions=model.proportions_,
                            gene_idx=np.asarray(model.gene_idx_),
                            adjacency=model.adjacency_))


def reference(state: dict, samples: list, device, precision: str, log):
    """The plain reference's whole fit of the same counts (every call fits
    them alike, so one reference serves every sample)."""
    t = time.perf_counter()
    ref = ref_fit.fit(state["Y"], state["X"], state["coords"],
                      state["cfg"]["fit"], device, precision)
    log(f"reference fit ({precision}) {ref.solution.n_iterations} sweeps, "
        f"{ref.gene_idx.size} genes, lambda {ref.lambda_!r} in "
        f"{time.perf_counter() - t:.3f} s")
    return ref


def as_call(ref, samples: list):
    """The reference's fit in the place of the sampled calls: (records,
    outputs)."""
    rec = dict(sweeps=ref.solution.n_iterations)
    out = dict(proportions=ref.proportions, gene_idx=ref.gene_idx,
               adjacency=ref.adjacency)
    return [rec for _ in samples], [out for _ in samples]


def compare(ref, samples: list, records: list) -> dict:
    """``genes_off`` and ``graph_off``: genes and edges that differ from the
    reference's, the largest over the sampled fits; ``sweeps_off``: the
    largest difference of a timed fit's sweeps; ``props_gap``: max |P -
    P_ref| over the sampled fits. (A wrong lambda, which the reference's
    control cannot separate from a right one, shows in ``props_gap``.)"""
    A_ref = ref.adjacency.astype(bool)
    inf = float("inf")
    return dict(
        genes_off=float(max((np.setxor1d(s["gene_idx"], ref.gene_idx).size
                             for s in samples), default=inf)),
        graph_off=float(max(((s["adjacency"].astype(bool) != A_ref).nnz
                             for s in samples), default=inf)),
        sweeps_off=float(max((abs(r["sweeps"] - ref.solution.n_iterations)
                              for r in records), default=inf)),
        props_gap=max((ref_solve.max_gap(torch.as_tensor(s["proportions"]),
                                         ref.proportions)
                       for s in samples), default=inf),
    )

