"""Inputs of every cell, made from the seed: the section's coordinates, its
kNN graph, the sketch-space problem of the solve cells and the counts and
reference signatures of the fit cells.

Everything that can be made on the card is made there, with a
``torch.Generator`` on the card seeded from ``--seed``, in a few large
calls: the sketch-space Y and the counts (in row chunks, copied to the host
as CSR). The coordinates follow from the configuration alone, and the graph
from the coordinates. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import sparse
from scipy.spatial import cKDTree

#: Sub-streams of one seed: each input draws from its own generator, so a
#: change to one input's recipe leaves the others' numbers as they were.
STREAM_SKETCH, STREAM_COUNTS, STREAM_SIGNATURES, STREAM_SAMPLE = 1, 2, 3, 4
STREAM_LAMBDA = 5


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for sub-stream ``stream`` of ``seed`` (any integer)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` for sub-stream ``stream``."""
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def layout_coords(layout: dict) -> np.ndarray:
    """(n, 2) float64 bin coordinates, in bins, row-major over the grid.

    ``kind`` "grid": every bin of a ``side`` x ``side`` grid. "tissue": the
    bins inside a disk of radius ``radius_share * side`` about the grid's
    centre, less the disks ``[cx, cy, r]`` of ``holes`` (bins strictly
    farther than r from a hole's centre are kept)."""
    side = int(layout["side"])
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    c = np.column_stack([xs.ravel(), ys.ravel()]).astype(np.float64)
    if layout["kind"] == "grid":
        return c
    if layout["kind"] != "tissue":
        raise ValueError(f"unknown layout kind {layout['kind']!r}")
    centre = (side - 1) / 2.0
    radius = float(layout["radius_share"]) * side
    keep = ((c - centre) ** 2).sum(1) <= radius * radius
    for cx, cy, r in layout["holes"]:
        keep &= ((c - (cx, cy)) ** 2).sum(1) > float(r) * float(r)
    return c[keep]


def knn_graph(coords: np.ndarray, k: int) -> sparse.csr_matrix:
    """Symmetrised binary kNN adjacency (A | A.T, no self loops), f64 CSR."""
    n = coords.shape[0]
    _, nbrs = cKDTree(coords).query(coords, k=k + 1, workers=-1)
    rows = np.repeat(np.arange(n), k + 1)
    cols = nbrs.ravel()
    keep = rows != cols
    A = sparse.csr_matrix(
        (np.ones(int(keep.sum())), (rows[keep], cols[keep])), shape=(n, n))
    A = (A + A.T).tocsr()
    A.data[:] = 1.0
    return A


def side_of(cfg: dict) -> float:
    return float(cfg["layout"]["side"])


def sketch_problem(cfg: dict, coords: np.ndarray, seed: int, device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sketch-space problem of ``bench.make_problem``'s recipe, made on
    ``device``: X (K, d) standard normal; a Gaussian bump per type about a
    uniform centre, normalised over the types, as the truth; Y = truth @ X
    plus ``noise`` times standard normal. X and the centres are the
    section's, drawn from the configuration's ``section_seed``; the noise
    is the run's, drawn from ``seed``. Returns f32 (Y (n, d), X (K, d)) on
    ``device``."""
    K, d = int(cfg["n_types"]), int(cfg["sketch_dim"])
    p = cfg["sketch_problem"]
    side = side_of(cfg)
    gs = generator(int(cfg["section_seed"]), STREAM_SKETCH, device)
    X = torch.randn((K, d), generator=gs, device=device, dtype=torch.float32)
    centers = torch.rand((K, 2), generator=gs, device=device,
                         dtype=torch.float64) * side
    g = generator(seed, STREAM_SKETCH, device)
    c = torch.as_tensor(coords, dtype=torch.float64, device=device)
    d2 = torch.cdist(c, centers) ** 2
    del c
    truth = torch.exp(-d2 / (2.0 * (float(p["width"]) * side) ** 2))
    truth = (truth / truth.sum(1, keepdim=True)).float()
    del d2
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        Y = truth @ X
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    del truth
    Y.add_(torch.randn(Y.shape, generator=g, device=device,
                       dtype=torch.float32), alpha=float(p["noise"]))
    return Y, X


def signatures(cfg: dict) -> np.ndarray:
    """The section's (K, G) f64 reference signatures, on the host (a small
    array), drawn from the configuration's ``section_seed``: gamma(2, 1) at
    density ``signature_density``, and ``markers_per_type`` genes a type
    expressed in that type alone at gamma(5, 2)."""
    K, G = int(cfg["n_types"]), int(cfg["n_genes"])
    c = cfg["counts"]
    rng = np.random.default_rng(stream_seed(int(cfg["section_seed"]),
                                            STREAM_SIGNATURES))
    X = rng.gamma(2.0, 1.0, (K, G))
    X *= rng.random((K, G)) < float(c["signature_density"])
    m = int(c["markers_per_type"])
    marks = rng.choice(G, m * K, replace=False)
    for k in range(K):
        cols = marks[k * m:(k + 1) * m]
        X[:, cols] = 0.0
        X[k, cols] = rng.gamma(5.0, 2.0, m)
    return X


def counts(cfg: dict, coords: np.ndarray, X: np.ndarray, seed: int, device
           ) -> sparse.csr_matrix:
    """Whole-transcriptome counts (n, G) as host CSR of float32 data and
    int32 indices, made on ``device`` in row chunks.

    Each bin's proportions are a softmax of a Gaussian bump per type about
    a uniform centre plus gumbel noise; its expected profile is the
    proportions times the signatures, normalised to sum to one and scaled
    by a gamma library size; the counts are Poisson draws of
    it (the recipe of ``chip_smoke.synthetic_counts``). The centres, the
    gumbel noise and the library sizes are the section's
    (``section_seed``), so every run fits the same expected counts; the
    Poisson draws are the run's (``seed``)."""
    c = cfg["counts"]
    K, G = X.shape
    side = side_of(cfg)
    n = coords.shape[0]
    gs = generator(int(cfg["section_seed"]), STREAM_COUNTS, device)
    centers = torch.rand((K, 2), generator=gs, device=device,
                         dtype=torch.float64) * side
    g = generator(seed, STREAM_COUNTS, device)
    Xn = torch.as_tensor(X, dtype=torch.float32, device=device)
    c_all = torch.as_tensor(coords, dtype=torch.float64, device=device)
    two_w2 = 2.0 * (float(c["width"]) * side) ** 2
    shape_a = torch.full((1,), float(c["umi_shape"]), device=device,
                         dtype=torch.float32)
    rows = int(c["chunk_rows"])
    indptr = [np.zeros(1, dtype=np.int64)]
    indices, data = [], []
    base = 0
    for s in range(0, n, rows):
        cc = c_all[s:s + rows]
        m = cc.shape[0]
        u = torch.rand((m, K), generator=gs, device=device,
                       dtype=torch.float64).clamp_(1e-300, 1.0)
        gumbel = -torch.log(-torch.log(u)) * float(c["gumbel"])
        logits = -(torch.cdist(cc, centers) ** 2) / two_w2 + gumbel
        p = torch.softmax(logits, dim=1).float()
        mean = p @ Xn
        mean /= mean.sum(1, keepdim=True)
        lib = torch._standard_gamma(shape_a.expand(m), generator=gs)
        mean *= (lib * float(c["umi_scale"]))[:, None]
        draw = torch.poisson(mean, generator=g)
        del mean
        csr = draw.to_sparse_csr()
        del draw
        crow = csr.crow_indices().cpu().numpy()
        indptr.append(crow[1:] + base)
        base += int(crow[-1])
        indices.append(csr.col_indices().to(torch.int32).cpu().numpy())
        data.append(csr.values().cpu().numpy())
    ptr = np.concatenate(indptr)
    if base < np.iinfo(np.int32).max:
        ptr = ptr.astype(np.int32)
    return sparse.csr_matrix(
        (np.concatenate(data), np.concatenate(indices), ptr), shape=(n, G))
