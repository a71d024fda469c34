"""Device CountSketch projection: Y (N x G) -> Y_sketch (N x d).

Counterpart of :mod:`flashdeconv_tpu.ops.countsketch`. Two device paths
(the host projection is a third, in :mod:`..core.sketching`):

* **matmul**: ``Y @ dense(Omega)`` in full f32 (TF32 off), as the JAX
  package leaves that product to XLA at ``Precision.HIGHEST``. Omega dense
  is only G x d.
* **the CUDA kernel** (:func:`countsketch_project_kernel`,
  ``csrc/countsketch_project.cu``): ``out[r, bucket[g]] += w[g] * Y[r, g]``
  with Omega implicit, reading each element of Y once. It replaces the
  Pallas kernel ``countsketch_project_pallas``.

:func:`countsketch_project` picks the kernel as the JAX package picks its
Pallas kernel (``G >= 4096`` and ``N >= 1024``, on the accelerator), less
the TPU's VMEM budget, which has no counterpart here.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from flashdeconv_tpu_torch.ops.bcd import (
    _raise_on_launch_error,
    full_f32_matmul,
)

#: The kernel engages for ``n_genes >= KERNEL_MIN_GENES`` and
#: ``n_rows >= KERNEL_MIN_ROWS`` on a CUDA tensor (JAX ``:83-88``).
KERNEL_MIN_GENES = 4096
KERNEL_MIN_ROWS = 1024


def kernel_route(device: torch.device, n_rows: int, n_genes: int) -> bool:
    """Whether :func:`countsketch_project` runs the kernel by default."""
    return (device.type == "cuda" and n_genes >= KERNEL_MIN_GENES
            and n_rows >= KERNEL_MIN_ROWS)


def countsketch_project(Y, op, dtype=torch.float32,
                        use_kernel: Optional[bool] = None, *, device="cuda"
                        ) -> torch.Tensor:
    """Project the rows of Y through a CountSketch operator on ``device``.

    Parameters
    ----------
    Y : (N, G) numpy array or tensor, cast to ``dtype`` on ``device``.
    op : :class:`flashdeconv_tpu_torch.core.sketching.CountSketchOp`.
    use_kernel : force the kernel on or off; default :func:`kernel_route`.
        The kernel works in f32, as the Pallas kernel does. On a CPU tensor
        ``True`` runs its plain version.

    Returns the (N, d) projection, a tensor on ``device``.
    """
    Y = torch.as_tensor(Y, dtype=dtype, device=torch.device(device))
    n, g = Y.shape
    if use_kernel is None:
        use_kernel = kernel_route(Y.device, n, g)
    if use_kernel:
        f32 = torch.float32
        return countsketch_project_kernel(
            Y.to(f32).contiguous(),
            torch.as_tensor(op.buckets, dtype=torch.int32, device=Y.device),
            torch.as_tensor(op.weights, dtype=f32, device=Y.device),
            op.sketch_dim,
        )
    omega = torch.as_tensor(op.to_dense(np.float32), dtype=dtype,
                            device=Y.device)
    return _matmul_project(Y, omega)


def _matmul_project(Y: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    # TF32 off: the sketch feeds Gram/Xty precomputations where TF32's ~3
    # digits would leak into solver parity (JAX: Precision.HIGHEST).
    with full_f32_matmul():
        return Y @ omega


def countsketch_project_reference(
    Y: torch.Tensor, buckets: torch.Tensor, weights: torch.Tensor,
    sketch_dim: int, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: ``out[:, buckets[g]] +=
    weights[g] * Y[:, g]``, genes in ascending order (on a CPU tensor; the
    card's ``index_add_`` adds in no fixed order). Returns ``out`` (N, d)."""
    if out is None:
        out = Y.new_zeros((Y.shape[0], sketch_dim))
    else:
        out.zero_()
    return out.index_add_(1, buckets.long(), Y * weights)


def _check_operands(Y, buckets, weights, sketch_dim, out):
    n, g = Y.shape
    if n < 1 or g < 1 or sketch_dim < 1:
        raise ValueError(f"empty projection: Y {tuple(Y.shape)}, "
                         f"sketch_dim {sketch_dim}")
    expect = {
        "Y": (Y, (n, g), torch.float32),
        "buckets": (buckets, (g,), torch.int32),
        "weights": (weights, (g,), torch.float32),
        "out": (out, (n, sketch_dim), torch.float32),
    }
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != Y.device:
            raise ValueError(f"{name} is on {t.device}, Y on {Y.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gene_plan(buckets: torch.Tensor, weights: torch.Tensor, sketch_dim: int,
              gene_tile: int):
    """The kernel's gene order: genes sorted by (tile, bucket, gene), their
    weights, and the (n_tiles * d + 1,) pointers of each tile's buckets, all
    on the buckets' device. Raises on a bucket outside ``[0, d)``."""
    lo, hi = torch.aminmax(buckets)
    if int(lo) < 0 or int(hi) >= sketch_dim:
        raise ValueError(f"buckets must lie in [0, {sketch_dim}), got "
                         f"[{int(lo)}, {int(hi)}]")
    g = buckets.shape[0]
    n_tiles = -(-g // gene_tile)
    gene = torch.arange(g, device=buckets.device)
    key = (gene // gene_tile) * sketch_dim + buckets.long()
    key, order = torch.sort(key, stable=True)
    ptr = torch.searchsorted(
        key, torch.arange(n_tiles * sketch_dim + 1, device=buckets.device))
    return (order.to(torch.int32), weights[order].contiguous(),
            ptr.to(torch.int32))


def _countsketch_project_cuda(Y, buckets, weights, sketch_dim, out):
    from flashdeconv_tpu_torch.ops import _build

    lib = _build.load("countsketch_project")
    genes, w, ptr = gene_plan(buckets, weights, sketch_dim,
                              lib.fdt_countsketch_gene_tile())
    n, g = Y.shape
    with _build.launch_stream(Y, genes, w, ptr, out) as stream:
        err = lib.fdt_countsketch_project(
            Y.data_ptr(), n, g, genes.data_ptr(), w.data_ptr(),
            ptr.data_ptr(), sketch_dim, out.data_ptr(), stream,
        )
    _raise_on_launch_error(lib, err, "countsketch_project")
    countsketch_project_kernel.launches += 1
    countsketch_project_kernel.card_launches[Y.device.index] += 1
    return out


def countsketch_project_kernel(
    Y: torch.Tensor, buckets: torch.Tensor, weights: torch.Tensor,
    sketch_dim: int, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CountSketch projection ``out[r, c] = sum_{g: buckets[g] = c}
    weights[g] * Y[r, g]`` with Omega implicit.

    ``Y`` (N, G) f32, ``buckets`` (G,) int32 in ``[0, sketch_dim)``,
    ``weights`` (G,) f32, all contiguous on one device; ``out`` an optional
    (N, sketch_dim) f32 buffer. On a CUDA tensor this launches the
    hand-written kernel ``csrc/countsketch_project.cu`` (and raises if it
    cannot): the genes are sorted by bucket on the card first (a few small
    launches per call), then every bucket's genes are summed in ascending
    order with no atomics, so two calls give the same bits. On a CPU tensor
    it runs :func:`countsketch_project_reference`.
    ``countsketch_project_kernel.launches`` counts the kernel's launches,
    ``.card_launches`` the same by the card's index.
    """
    if Y.dim() != 2:
        raise ValueError(f"Y must be 2-D, got shape {tuple(Y.shape)}")
    if out is None:
        out = Y.new_empty((Y.shape[0], sketch_dim))
    _check_operands(Y, buckets, weights, sketch_dim, out)
    if Y.device.type == "cuda":
        return _countsketch_project_cuda(Y, buckets, weights, sketch_dim, out)
    if Y.device.type == "cpu":
        return countsketch_project_reference(Y, buckets, weights, sketch_dim,
                                             out=out)
    raise ValueError(f"no CountSketch projection for device {Y.device}")


countsketch_project_kernel.launches = 0
countsketch_project_kernel.card_launches = collections.Counter()
