"""Plain reference of the spatially regularised NNLS solve, in PyTorch.

min_beta 0.5 ||Y - beta X||^2 + 0.5 lambda Tr(beta^T L beta)
         + rho_eff ||beta||_1,  beta >= 0,

with L the Laplacian of the binary graph A (every stored edge counts 1)
and rho_eff = rho * mean(diag(X X^T)), solved by FlashDeconv's block
coordinate descent: each sweep forms the neighbour sums of the previous
sweep's beta (Jacobi across spots), then updates the K coordinates of every
spot in order (Gauss-Seidel within a spot),

    beta[:, k] = max(0, Xty[:, k] + lambda * ns[:, k]
                        - sum_{j != k} XtX[k, j] beta[:, j] - rho_eff)
                 / (XtX[k, k] + lambda * degree),

the denominator mapped to 0 where it is <= 1e-10, from a uniform 1/K start,
until max|beta - beta_old| / (max|beta_old| + 1e-10) < tol (the sweep that
meets the rule is kept) or ``max_iter`` sweeps.

It works everything out from the inputs (Y or Xty, X, A) and imports nothing
of the program. ``precision`` "f64" is the reference; "tf32" is the control
of the correctness check: every matrix product with its operands rounded to
TF32 (10 mantissa bits, to nearest even) and the rest in float32, the
precision below the float32-with-TF32-off that the configurations state.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from scipy import sparse

PRECISIONS = ("f64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as float32 rounded to TF32's 10 mantissa bits (to nearest,
    ties to even), as a tensor core reads an f32 operand in TF32 mode."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0x0FFF + lsb) & ~0x1FFF
    return i.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` in the reference's precision: f64, or TF32 operands with
    float32 accumulation (TF32 itself switched off, so the product sees
    exactly the rounded operands)."""
    if precision == "f64":
        return a.double() @ b.double()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return round_tf32(a) @ round_tf32(b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def xty_from_sketch(Y: np.ndarray, X: np.ndarray, precision: str, device,
                    rows: int = 1 << 17) -> torch.Tensor:
    """Xty = Y X^T, (n, K), on ``device`` in row blocks of ``Y``."""
    Xd = torch.as_tensor(np.asarray(X), device=device)
    parts = []
    for s in range(0, Y.shape[0], rows):
        Yb = torch.as_tensor(np.asarray(Y[s:s + rows]), device=device)
        parts.append(matmul(Yb, Xd.T, precision).to(dtype_of(precision)))
    return torch.cat(parts)


class Solution(NamedTuple):
    beta: torch.Tensor      # (n, K), the reference's dtype
    n_iterations: int
    rel_changes: List[float]


def bcd(Xty: torch.Tensor, XtX: np.ndarray, A: sparse.spmatrix,
        lambda_: float, rho: float, tol: float, max_iter: int,
        precision: str = "f64") -> Solution:
    """The block coordinate descent above from a cold start. ``Xty`` (n, K)
    on the device the solve runs on; ``XtX`` (K, K) host f64 (the penalty
    scale is its mean diagonal); ``A`` (n, n) host sparse, binary by its
    pattern."""
    dev = Xty.device
    dt = dtype_of(precision)
    n, K = Xty.shape
    Xty = Xty.to(dt)
    XtX64 = np.asarray(XtX, dtype=np.float64)
    rho_eff = float(rho) * float(np.mean(np.diag(XtX64)))
    G = torch.as_tensor(XtX64, device=dev).to(dt)
    Ac = sparse.csr_matrix(A)
    deg = torch.as_tensor(np.diff(Ac.indptr).astype(np.float64),
                          device=dev).to(dt)
    rows = torch.as_tensor(np.repeat(np.arange(n), np.diff(Ac.indptr)),
                           device=dev)
    cols = torch.as_tensor(Ac.indices.astype(np.int64), device=dev)
    den = torch.diagonal(G)[None, :] + lambda_ * deg[:, None]
    inv_den = torch.where(den > 1e-10, 1.0 / den, torch.zeros_like(den))
    beta = torch.full((n, K), 1.0 / K, dtype=dt, device=dev)
    rels: List[float] = []
    for _ in range(max_iter):
        old = beta.clone()
        ns = torch.zeros_like(old).index_add_(0, rows, old[cols])
        for k in range(K):
            r = matmul(beta, G[:, k:k + 1], precision).to(dt)[:, 0]
            r = r - G[k, k] * beta[:, k]
            num = Xty[:, k] + lambda_ * ns[:, k] - r - rho_eff
            beta[:, k] = torch.clamp_min(num, 0.0) * inv_den[:, k]
        rel = float(torch.amax(torch.abs(beta - old))
                    / (torch.amax(torch.abs(old)) + 1e-10))
        rels.append(rel)
        if rel < tol:
            break
    return Solution(beta, len(rels), rels)


def normalize(beta: torch.Tensor) -> torch.Tensor:
    """Rows of ``beta`` over their sums; an all-zero row becomes 1/K."""
    s = beta.sum(1, keepdim=True)
    p = beta / torch.clamp_min(s, 1e-10)
    return torch.where(s == 0, torch.full_like(p, 1.0 / beta.shape[1]), p)


def max_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max |got - ref| over max |ref|, in float64."""
    got = got.to(ref.device, torch.float64)
    ref = ref.double()
    return float(torch.amax(torch.abs(got - ref))
                 / torch.clamp_min(torch.amax(torch.abs(ref)), 1e-300))
