"""Block-coordinate-descent sweeps of the three solve tiers: plain PyTorch
and the two CUDA kernels.

Counterpart of :mod:`flashdeconv_tpu.ops.bcd`. Every tier carries beta in
the transposed ``(K, n)`` layout of the TPU kernels' operands, runs the
same Gauss-Seidel pass (Jacobi across spots, Gauss-Seidel over the K
coordinates of each spot) with the per-solve reciprocal denominator
:func:`gs_inv_den`, and stops on the same rule:

- the fused banded tier sweeps a block-padded carry ``(K, n_solve +
  2*h*block)`` with uint8 band masks in one launch of
  ``csrc/fused_banded_sweep.cu`` (:func:`fused_banded_sweep`); a small
  remainder of rest edges rides along as a (K, n_solve) ``ns_rest`` input,
  refreshed in plain PyTorch before each launch at the touched columns
  only (:func:`build_fused_rest_tables`, :func:`rest_ns_update`);
- the unfused banded tier (:func:`bcd_sweep_banded`) and the gather tier
  (:func:`bcd_sweep`) form the neighbour sums first — shifted slices times
  masks in plain PyTorch plus a rest table, or a padded neighbour table
  (sentinel n) and an overflow table for degree-capped hubs; each table's
  sums are one launch of ``neighbor_sum_kernel`` of
  ``csrc/cd_block_sweep.cu`` on a CUDA f32 carry (:func:`neighbor_sum`),
  the plain loop otherwise — and then run their Gauss-Seidel pass
  (:func:`gs_pass_fn`): at f32 with
  K <= 384 a launch of ``csrc/cd_block_sweep.cu``
  (:func:`coordinate_descent_block`), otherwise :func:`coordinate_descent`,
  the JAX package's XLA tier (f64 at any K, and K > 384): one coordinate
  at a time for all spots, a maintained residual ``r = XtX^T beta`` with a
  rank-1 refresh, its denominator formed inside the sweep.

The fused tier's objective, on a CUDA f32 carry at K <= 56, is one launch
of a third kernel of ``csrc/fused_banded_sweep.cu``
(:func:`fused_banded_objective`), which forms its sums with the sweep
kernels' band loader; every other carry runs the plain version
(:func:`objective_terms_banded_fused_reference`).

Both kernels run one Gauss-Seidel device function — ``csrc/gs_pass.cuh``
at K <= 32, the panel pass of ``csrc/gs_pass_panel.cuh`` at 32 < K <= 384
— so the fused and unfused banded sweeps are bitwise equal on the card, as
their plain versions are on the CPU. Every function here is plain PyTorch
on tensors of an explicit device, except the kernel wrappers: a CUDA
tensor launches the kernel (or raises), a CPU tensor runs the plain
version beside it. :func:`fused_solve` is the one solve of all three
tiers; its stopping rule (:func:`converge`) and chunked loop
(:func:`run_prepared_solve`) are the meshes' too. The solve has no
gradient; none of its tensors requires one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flashdeconv_tpu_torch.utils.timing import span

# Gauss-Seidel pass dispatch, as in flashdeconv_tpu/ops/bcd.py: the classic
# pass at K <= 8, panels of 8 through K = 64, panels of 16 above.
_GS_PANEL_ENGAGE_K = 8
_GS_PANEL_P_SMALL = 8
_GS_PANEL_P = 16
_GS_PANEL_WIDE_K = 64

#: Largest K of the kernels' register pass (``gs_pass.cuh``, register
#: arrays templated on 8, 16, 24 and 32); above it both kernels launch their
#: panel form (``gs_pass_panel.cuh``), counted apart as ``large_k_launches``.
REGISTER_PASS_MAX_K = 32
#: Largest K of the fused kernel's spot-panel pass (``FDT_SPOT_PANEL_MAX_K``
#: in ``gs_pass_panel.cuh``: one thread a spot, panels of 16 rows); above
#: ``REGISTER_PASS_MAX_K`` and up to this K kernel #1 runs it in place of
#: the tile pass, chosen by K alone, and counts those launches apart as
#: ``spot_panel_launches`` too.
SPOT_PANEL_MAX_K = 64
#: Largest K of the fused tier's objective kernel (``csrc/
#: fused_banded_sweep.cu``, instances KMAX = 8, 16, ..., 56): the register
#: pass's range and most of the panel pass's TM = 2 range (a KMAX = 64
#: instance spilled registers). Its launches above ``REGISTER_PASS_MAX_K``
#: count apart as ``large_k_launches``; above this, and on the CPU or in
#: f64, the objective takes the plain path.
OBJECTIVE_KERNEL_MAX_K = 56
#: Largest K the CUDA kernels take (the panel form's shared-memory tiles
#: are sized for it); the wrappers raise above it. A departure from the
#: JAX package, which runs its XLA tier above K = 256 on the TPU: here only
#: f64 and K > 384 run :func:`coordinate_descent`.
KERNEL_MAX_K = 384
#: Largest K of the tile pass's two-blocks-an-SM instances (TM <= 8);
#: above it (TM = 9 to 12, one block an SM) both sweep kernels count their
#: launches apart as ``wide_launches`` too, and kernel #1 runs the pass's
#: WIDE form (``csrc/gs_pass_panel.cuh``: the same operations, more of its
#: loads in flight).
WIDE_ABOVE_K = 256
#: Largest band count the fused kernel takes (one bit per band per spot).
KERNEL_MAX_BANDS = 32


@contextlib.contextmanager
def full_f32_matmul() -> Iterator[None]:
    """Pin full-f32 matmuls (TF32 off) for the block, restoring after.

    Mirrors ``_PREC = HIGHEST`` of the JAX solver: the residual subtracts
    quantities of similar size (Xty - XtX @ beta), so TF32's ~3 decimal
    digits would inject visible noise into the iterate path.
    """
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in f32 ops)."""
    return float(np.float32(x))


def scalar(x, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (float32 or float64), as a Python float:
    the solve's scalars (lambda, rho, tol) in its dtype, as the JAX solver
    makes them ``jnp.asarray(x, dtype)``."""
    return f32(x) if dtype == torch.float32 else float(x)


def kernel_takes(dtype: torch.dtype, n_types: int) -> bool:
    """Whether the sweep kernels take a solve of this dtype and K: f32 with
    K <= ``KERNEL_MAX_K``. Every other solve runs :func:`coordinate_descent`,
    as the JAX package runs its XLA tier on every problem its Pallas
    kernels do not take."""
    return dtype == torch.float32 and n_types <= KERNEL_MAX_K


def soft_threshold(x: torch.Tensor, threshold) -> torch.Tensor:
    """Elementwise soft-thresholding prox for the L1 penalty."""
    return torch.sign(x) * torch.clamp_min(torch.abs(x) - threshold, 0.0)


def _gs_panel_width(n_types: int) -> Optional[int]:
    """Panel width :func:`gs_pass` uses at this K — None = classic pass."""
    if n_types <= _GS_PANEL_ENGAGE_K:
        return None
    return _GS_PANEL_P_SMALL if n_types <= _GS_PANEL_WIDE_K else _GS_PANEL_P


def gs_inv_den(XtX: torch.Tensor, n_nbrs: torch.Tensor, lam) -> torch.Tensor:
    """Per-solve reciprocal denominator ``1 / (diag(XtX) + lam * degree)``.

    ``den <= 1e-10`` maps to 0, so ``num * inv_den`` gives the guarded 0.0
    without a branch. ``n_nbrs``: (B,) or (1, B) degrees. Returns (K, B).
    """
    diag = torch.diagonal(XtX)[:, None]
    den = diag + scalar(lam, XtX.dtype) * n_nbrs.reshape(1, -1).to(XtX.dtype)
    return torch.where(den > 1e-10, 1.0 / den, torch.zeros_like(den))


def _gs_prologue(beta_old, xty, xtx, ns, lam, rho):
    """``C = xty + lam*ns - XtX @ beta_old + diag(XtX)*beta_old - rho``,
    the coordinate-order-independent part of every numerator, (K, B)."""
    r0 = xtx @ beta_old
    diag = torch.diagonal(xtx)[:, None]
    return (xty + f32(lam) * ns - r0 + diag * beta_old) - f32(rho)


def _gs_pass_kb(beta_old, xty, xtx, ns, inv_den, lam, rho):
    """Classic (K, B) Gauss-Seidel pass: a rank-1 refresh of the whole
    accumulator after every coordinate. Returns the updated (K, B) beta."""
    K = beta_old.shape[0]
    C = _gs_prologue(beta_old, xty, xtx, ns, lam, rho)
    acc = torch.zeros_like(beta_old)
    deltas = []
    for k in range(K):
        num = torch.clamp_min(C[k:k + 1] - acc[k:k + 1], 0.0)
        delta = num * inv_den[k:k + 1] - beta_old[k:k + 1]
        acc = acc + xtx[:, k:k + 1] * delta
        deltas.append(delta)
    return torch.cat(deltas, dim=0) + beta_old


def _gs_pass_kb_panel(beta_old, xty, xtx, ns, inv_den, lam, rho,
                      panel: int = _GS_PANEL_P):
    """Panel Gauss-Seidel pass — the classic pass's iterate, with each
    panel's corrections from all finished coordinates as one matmul."""
    K, B = beta_old.shape
    C = _gs_prologue(beta_old, xty, xtx, ns, lam, rho)
    delta_panels = []
    a = 0
    while a < K:
        b = min(a + panel, K)
        if delta_panels:
            acc_p = xtx[a:b, :a] @ torch.cat(delta_panels, dim=0)
        else:
            acc_p = beta_old.new_zeros((b - a, B))
        pdeltas = []
        for i in range(b - a):
            k = a + i
            num = torch.clamp_min(C[k:k + 1] - acc_p[i:i + 1], 0.0)
            delta = num * inv_den[k:k + 1] - beta_old[k:k + 1]
            acc_p = acc_p + xtx[a:b, k:k + 1] * delta
            pdeltas.append(delta)
        delta_panels.append(torch.cat(pdeltas, dim=0))
        a = b
    return torch.cat(delta_panels, dim=0) + beta_old


def gs_pass(beta_old, xty, xtx, ns, inv_den, lam, rho):
    """The Gauss-Seidel coordinate pass, dispatched on K as the JAX
    package's ``gs_pass`` is: classic at K <= 8, panel 8 through K = 64,
    panel 16 above."""
    p = _gs_panel_width(beta_old.shape[0])
    if p is not None:
        return _gs_pass_kb_panel(beta_old, xty, xtx, ns, inv_den, lam, rho,
                                 panel=p)
    return _gs_pass_kb(beta_old, xty, xtx, ns, inv_den, lam, rho)


def uniform_beta0(Xty_t: torch.Tensor, n_spots: int) -> torch.Tensor:
    """The cold start: (n_solve, K) with 1/K on the first ``n_spots`` rows
    and zero padding rows."""
    K, n_solve = Xty_t.shape
    beta0 = Xty_t.new_zeros((n_solve, K))
    beta0[:n_spots] = 1.0 / K
    return beta0


def to_fused_carry(beta0: torch.Tensor, h: int, block: int) -> torch.Tensor:
    """(n_solve, K) beta -> the transposed carry with ``h`` zero pad blocks
    on each side, (K, n_solve + 2*h*block)."""
    n_solve, K = beta0.shape
    pad = h * block
    carry = beta0.new_zeros((K, n_solve + 2 * pad))
    carry[:, pad:pad + n_solve] = beta0.T
    return carry


def from_fused_carry(beta_ext_t: torch.Tensor, h: int, block: int
                     ) -> torch.Tensor:
    """Transposed padded carry -> (n_solve, K) beta (a view)."""
    pad = h * block
    return beta_ext_t[:, pad:beta_ext_t.shape[1] - pad].T


def _banded_neighbor_sum(src: torch.Tensor, masks: torch.Tensor,
                         offsets: Tuple[int, ...], pad: int) -> torch.Tensor:
    """The banded neighbour sums (K, n) of the ``n = masks.shape[1]`` data
    columns of ``src``, which holds ``pad`` columns before them: each band
    ``off`` adds ``masks[u] * src[:, pad + j + off]`` over the columns
    ``j`` whose source column ``src`` holds, bands in ``offsets`` order
    from a zero start, in the masks' dtype as given. The one banded sum of
    the unfused tier (``pad`` 0), the fused tier's plain sums (the carry,
    ``pad = h * block``) and the banded mesh (a halo window); a pad as wide
    as the largest offset clips no band."""
    K, n_src = src.shape
    n = masks.shape[1]
    ns = src.new_zeros((K, n))
    for u, off in enumerate(offsets):
        lo, hi = max(0, -pad - off), min(n, n_src - pad - off)
        if lo < hi:
            ns[:, lo:hi] += (masks[u, lo:hi]
                             * src[:, pad + lo + off:pad + hi + off])
    return ns


@dataclasses.dataclass(frozen=True)
class SweepRange:
    """The columns one fused sweep call covers.

    The window of ``n_sub + 2*pad`` carry columns starts at column
    ``in_col0`` of the input carry; its data columns are the data columns
    ``[data0, data0 + n_sub)`` of ``Xty_t``, ``masks`` and ``inv_den_t``;
    window column ``w`` goes to column ``out_col0 + w`` of the output.
    ``write_pads``: the window's pad columns are written as zeros (a whole
    sweep, or a sub-carry of its own); otherwise only data columns are
    written (a sub-range into a full carry).
    """

    in_col0: int
    data0: int
    n_sub: int
    out_col0: int
    write_pads: bool


def sweep_range(n_ext: int, n_data: int, h: int, block: int,
                sub: Optional[Tuple[int, int, int]], into_carry: bool
                ) -> SweepRange:
    """The :class:`SweepRange` of a fused sweep call on a carry of
    ``n_ext`` columns and data arrays of ``n_data`` columns. ``sub`` is
    None (the whole sweep) or ``(carry_start, data_start, n_data_blocks)``
    in blocks, as the JAX ``fused_banded_sweep(sub=...)`` takes it;
    ``into_carry``: the call writes into a given full carry ``out`` (the
    counterpart of the JAX ``out_alias``). Raises on a range that leaves
    the carry or the data."""
    pad = h * block
    if sub is None:
        if n_ext != n_data + 2 * pad or n_data <= 0:
            raise ValueError(
                f"carry width {n_ext} is not the {n_data} data columns plus "
                f"2 * h * block = {2 * pad} pad")
        return SweepRange(0, 0, n_data, 0, True)
    carry_start, data_start, n_blocks = (int(v) for v in sub)
    if min(carry_start, data_start) < 0 or n_blocks < 1:
        raise ValueError(f"sub={sub}: starts must be >= 0 and the range "
                         "at least one block")
    if (carry_start + n_blocks + 2 * h) * block > n_ext:
        raise ValueError(f"sub={sub}: the window of {n_blocks} + 2h blocks "
                         f"from block {carry_start} leaves the carry of "
                         f"{n_ext} columns")
    if (data_start + n_blocks) * block > n_data:
        raise ValueError(f"sub={sub}: data blocks leave the {n_data} data "
                         "columns")
    return SweepRange(carry_start * block, data_start * block,
                      n_blocks * block, data_start * block if into_carry
                      else 0, not into_carry)


def fused_banded_sweep_reference(
    beta_ext_t, Xty_t, XtX, masks, inv_den_t, lambda_, rho,
    offsets: Tuple[int, ...], h: int, block: int,
    out: Optional[torch.Tensor] = None,
    sub: Optional[Tuple[int, int, int]] = None,
    ns_rest_t: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the fused banded sweep kernel.

    Same operands and results as :func:`fused_banded_sweep`: reads the
    carry ``beta_ext_t``, writes the new carry (into ``out`` when given;
    pad columns zeroed, except for a sub-range written into a full carry,
    which writes only its data columns) and returns ``(carry, max|beta -
    beta_old|, max|beta_old|)`` over the call's data columns, the
    statistics as 0-d tensors on the carry's device. ``ns_rest_t`` (K,
    n_solve), when given, adds once after the bands.
    """
    K, n_ext = beta_ext_t.shape
    pad = h * block
    rng = sweep_range(n_ext, Xty_t.shape[1], h, block, sub, out is not None
                      and sub is not None)
    n, d0 = rng.n_sub, rng.data0
    win = beta_ext_t[:, rng.in_col0:rng.in_col0 + n + 2 * pad]
    ns = _banded_neighbor_sum(win, masks[:, d0:d0 + n].to(beta_ext_t.dtype),
                              offsets, pad)
    if ns_rest_t is not None:
        ns = ns + ns_rest_t[:, d0:d0 + n]
    beta_old = win[:, pad:pad + n].contiguous()
    beta = gs_pass(beta_old, Xty_t[:, d0:d0 + n], XtX, ns,
                   inv_den_t[:, d0:d0 + n], lambda_, rho)
    if out is None:
        out = beta_ext_t.new_empty((K, n + 2 * pad))
    o = rng.out_col0
    if rng.write_pads:
        out[:, o:o + pad] = 0.0
        out[:, o + pad + n:o + n + 2 * pad] = 0.0
    out[:, o + pad:o + pad + n] = beta
    return (out, *sweep_stats(beta, beta_old))


def _check_bands(offsets, h: int, block: int) -> None:
    """Raise unless there are 1..``KERNEL_MAX_BANDS`` band offsets, each
    within the carry's pad ``h * block``."""
    if not 0 < len(offsets) <= KERNEL_MAX_BANDS:
        raise ValueError(f"the fused kernels take 1..{KERNEL_MAX_BANDS} "
                         f"bands, got {len(offsets)}")
    if max(abs(int(o)) for o in offsets) > h * block:
        raise ValueError("a band offset exceeds the carry's pad h * block")


def _check_layout(expect, device) -> None:
    """Raise unless each ``name: (tensor, shape, dtype)`` of ``expect`` has
    that shape and dtype, lies on ``device`` (the carry's) and is
    contiguous."""
    for name, (t, shape, dtype) in expect.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the carry on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_sweep_operands(beta_ext_t, Xty_t, XtX, masks, inv_den_t,
                          offsets, h, block, out, out_cols: int,
                          ns_rest_t=None):
    K, n_ext = beta_ext_t.shape
    n_data = Xty_t.shape[1]
    if K > KERNEL_MAX_K:
        raise ValueError(f"the fused kernel takes K <= {KERNEL_MAX_K}, "
                         f"got K = {K}")
    _check_bands(offsets, h, block)
    expect = {
        "Xty_t": (Xty_t, (K, n_data), torch.float32),
        "XtX": (XtX, (K, K), torch.float32),
        "masks": (masks, (len(offsets), n_data), torch.uint8),
        "inv_den_t": (inv_den_t, (K, n_data), torch.float32),
        "beta_ext_t": (beta_ext_t, (K, n_ext), torch.float32),
        "out": (out, (K, out_cols), torch.float32),
    }
    if ns_rest_t is not None:
        expect["ns_rest_t"] = (ns_rest_t, (K, n_data), torch.float32)
    _check_layout(expect, beta_ext_t.device)
    if out.data_ptr() == beta_ext_t.data_ptr():
        raise ValueError("the sweep is Jacobi across spots: out must not "
                         "be the input carry")


def _raise_on_launch_error(lib, err: int, name: str) -> None:
    if err:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({lib.fdt_error_string(err).decode()})"
        )


def fused_sweep_launch(lib, stream: int, beta_ext_t, Xty_t, XtX, masks,
                       inv_den_t, lambda_, rho, offsets, h: int, block: int,
                       out, rng: SweepRange, ns_rest_t=None) -> torch.Tensor:
    """One call of ``fdt_fused_banded_sweep`` of ``lib`` on ``stream`` over
    ``rng``; returns the (2, blocks) partials of the two statistics. The
    operands are checked by the caller; ``ns_rest_t`` None passes a null
    pointer (no rest input)."""
    K, n_ext = beta_ext_t.shape
    pad = h * block
    n_cols = rng.n_sub + (2 * pad if rng.write_pads else 0)
    partials = beta_ext_t.new_empty(
        (2, lib.fdt_fused_banded_sweep_blocks(n_cols, K)))
    offs = (ctypes.c_int * len(offsets))(*(int(o) for o in offsets))
    err = lib.fdt_fused_banded_sweep(
        beta_ext_t.data_ptr(), n_ext, rng.in_col0, out.data_ptr(),
        out.shape[1], rng.out_col0, Xty_t.data_ptr(), masks.data_ptr(),
        inv_den_t.data_ptr(),
        None if ns_rest_t is None else ns_rest_t.data_ptr(),
        Xty_t.shape[1], rng.data0, XtX.data_ptr(),
        offs, len(offsets), K, pad, rng.n_sub, int(rng.write_pads),
        f32(lambda_), f32(rho), partials.data_ptr(), stream,
    )
    _raise_on_launch_error(lib, err, "fused_banded_sweep")
    return partials


def _fused_banded_sweep_cuda(beta_ext_t, Xty_t, XtX, masks, inv_den_t,
                             lambda_, rho, offsets, h, block, out, rng, sub,
                             ns_rest_t):
    from flashdeconv_tpu_torch.ops import _build

    lib = _build.load("fused_banded_sweep")
    with _build.launch_stream(beta_ext_t, Xty_t, XtX, masks, inv_den_t, out,
                              ns_rest_t) as stream:
        partials = fused_sweep_launch(
            lib, stream, beta_ext_t, Xty_t, XtX, masks, inv_den_t, lambda_,
            rho, offsets, h, block, out, rng, ns_rest_t)
    fused_banded_sweep.card_launches[beta_ext_t.device.index] += 1
    if REGISTER_PASS_MAX_K < beta_ext_t.shape[0] <= SPOT_PANEL_MAX_K:
        fused_banded_sweep.spot_panel_launches += 1
    if beta_ext_t.shape[0] > WIDE_ABOVE_K:
        fused_banded_sweep.wide_launches += 1
    if sub is not None:
        fused_banded_sweep.sub_launches += 1
    elif ns_rest_t is not None:
        fused_banded_sweep.rest_launches += 1
    elif beta_ext_t.shape[0] > REGISTER_PASS_MAX_K:
        fused_banded_sweep.large_k_launches += 1
    else:
        fused_banded_sweep.launches += 1
    stats = torch.amax(partials, dim=1)
    return out, stats[0], stats[1]


def fused_banded_sweep(
    beta_ext_t: torch.Tensor,
    Xty_t: torch.Tensor,
    XtX: torch.Tensor,
    masks: torch.Tensor,
    inv_den_t: torch.Tensor,
    lambda_,
    rho,
    offsets: Tuple[int, ...],
    h: int,
    block: int,
    out: Optional[torch.Tensor] = None,
    sub: Optional[Tuple[int, int, int]] = None,
    ns_rest_t: Optional[torch.Tensor] = None,
):
    """One fused banded BCD sweep on the transposed padded carry.

    Parameters
    ----------
    beta_ext_t : (K, n_ext) f32 carry: ``n_solve + 2*h*block`` columns for
        the whole sweep, pad slabs zero (or, on a shard of the banded
        mesh, holding the neighbour shards' boundary blocks).
    Xty_t, inv_den_t : (K, n_solve) f32; XtX : (K, K) f32.
    masks : (U, n_solve) uint8 0/1 band masks, one row per offset.
    offsets : band offsets, each ``|o| <= h * block``.
    out : optional buffer for the new carry, distinct from ``beta_ext_t``
        (Jacobi: every spot reads the pre-sweep carry). Solve loops pass a
        second carry allocated once and ping-pong.
    sub : optional ``(carry_start, data_start, n_data_blocks)``, the
        sub-range form of the JAX ``fused_banded_sweep`` (the banded mesh's
        halo-overlap split): the window's blocks start at block
        ``carry_start`` of ``beta_ext_t``, its data blocks are the data
        blocks ``[data_start, data_start + n_data_blocks)`` of ``Xty_t``,
        ``masks`` and ``inv_den_t``, and the statistics cover only those.
        Without ``out`` it returns the sub-carry ``(K, (n_data_blocks +
        2h) * block)`` with zero pads; with ``out`` (a full carry, ``(K,
        n_solve + 2*h*block)``; the JAX ``out_alias``) it writes only the
        range's data columns, at block ``data_start + h``, and no pad.
    ns_rest_t : optional (K, n_solve) f32 rest-edge neighbour sums
        (:func:`rest_ns_update` refreshes them before each sweep), added
        once after the bands, as the unfused tier adds its rest table's
        sums; indexed by data column, like ``Xty_t``.

    Returns ``(new carry, max_diff, max_abs)``, the statistics as 0-d f32
    tensors on the carry's device. On a CUDA carry this launches the
    hand-written kernel (and raises if it cannot); on a CPU carry it runs
    :func:`fused_banded_sweep_reference`. Each launch counts once:
    ``fused_banded_sweep.sub_launches`` the sub-range launches at any K,
    ``.rest_launches`` the whole-sweep launches with ``ns_rest_t`` at any
    K, ``.large_k_launches`` the other whole-sweep launches of the panel
    form (K > ``REGISTER_PASS_MAX_K`` = 32) and ``.launches`` those of the
    register form (K <= 32); ``.spot_panel_launches`` counts, besides, every
    launch (whole, sub-range or rest) of the spot-panel pass (32 < K <=
    ``SPOT_PANEL_MAX_K``), ``.wide_launches`` every launch (whole,
    sub-range or rest) of the tile pass's WIDE form, which runs K >
    ``WIDE_ABOVE_K`` = 256 one block an SM;
    ``.card_launches`` counts every launch by the card's index.
    """
    pad = h * block
    rng = sweep_range(beta_ext_t.shape[1], Xty_t.shape[1], h, block, sub,
                      out is not None and sub is not None)
    buf = out if out is not None else beta_ext_t.new_empty(
        (beta_ext_t.shape[0], rng.n_sub + 2 * pad))
    _check_sweep_operands(
        beta_ext_t, Xty_t, XtX, masks, inv_den_t, offsets, h, block, buf,
        (rng.n_sub if rng.write_pads else Xty_t.shape[1]) + 2 * pad,
        ns_rest_t)
    if beta_ext_t.device.type == "cuda":
        return _fused_banded_sweep_cuda(
            beta_ext_t, Xty_t, XtX, masks, inv_den_t, lambda_, rho,
            offsets, h, block, buf, rng, sub, ns_rest_t,
        )
    if beta_ext_t.device.type == "cpu":
        return fused_banded_sweep_reference(
            beta_ext_t, Xty_t, XtX, masks, inv_den_t, lambda_, rho,
            offsets, h, block, out=out, sub=sub, ns_rest_t=ns_rest_t,
        )
    raise ValueError(f"no fused sweep for device {beta_ext_t.device}")


fused_banded_sweep.launches = 0
fused_banded_sweep.large_k_launches = 0
fused_banded_sweep.spot_panel_launches = 0
fused_banded_sweep.wide_launches = 0
fused_banded_sweep.sub_launches = 0
fused_banded_sweep.rest_launches = 0
fused_banded_sweep.card_launches = collections.Counter()


def sweep_stats(beta_out: torch.Tensor, beta_in: torch.Tensor):
    """Convergence statistics of one sweep, ``(max |beta_out - beta_in|,
    max |beta_in|)``, as 0-d tensors (``torch.amax`` keeps a NaN)."""
    return (torch.amax(torch.abs(beta_out - beta_in)),
            torch.amax(torch.abs(beta_in)))


# ---------------------------------------------------------------------------
# The unfused tiers: neighbour sums (a kernel on the card), then the GS
# kernel.
# ---------------------------------------------------------------------------

def with_sentinel(beta_t: torch.Tensor) -> torch.Tensor:
    """(K, n) -> (K, n + 1) with a zero last column: the sentinel that the
    padding slots of a neighbour table (index n) gather."""
    return torch.nn.functional.pad(beta_t, (0, 1))


def neighbor_sum_reference(src_t: torch.Tensor, nbr_t: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`neighbor_sum`, under its index rule:
    one ``index_select`` a slot over :func:`with_sentinel`'s copy of
    ``src_t`` (so an index of n_cols reads +0.0), slot 0 first, each later
    slot added in place, as the JAX ``neighbor_sum`` does. An index
    outside [0, n_cols] raises."""
    src_ext_t = with_sentinel(src_t)
    acc = torch.index_select(src_ext_t, 1, nbr_t[0])
    for d in range(1, nbr_t.shape[0]):
        acc += torch.index_select(src_ext_t, 1, nbr_t[d])
    return acc


def neighbor_sum_kernel_takes(beta_t: torch.Tensor) -> bool:
    """Whether :func:`neighbor_sum` launches the kernel on this carry: a
    CUDA f32 one. A CPU or f64 carry runs the plain loop (the XLA tier's,
    as in the JAX package)."""
    return beta_t.device.type == "cuda" and beta_t.dtype == torch.float32


def neighbor_sum_launch(lib, stream: int, src_t: torch.Tensor,
                        nbr_t: torch.Tensor, out: torch.Tensor
                        ) -> torch.Tensor:
    """One call of ``fdt_neighbor_sum`` of ``lib`` on ``stream``: the sums
    of the (D, n) int32 table ``nbr_t`` over the (K, n_cols) f32 source
    ``src_t`` into the (K, n) f32 ``out``, all contiguous on one device
    (checked here; raises ValueError otherwise, and RuntimeError when the
    launch fails). Every index must lie in [0, n_cols] (not checked: the
    table is on the card). Returns ``out``."""
    K, n_cols = src_t.shape
    if nbr_t.dim() != 2 or nbr_t.shape[0] < 1:
        raise ValueError(f"nbr_t: expected a (D, n) table with D >= 1, got "
                         f"shape {tuple(nbr_t.shape)}")
    n = nbr_t.shape[1]
    _check_layout({
        "src_t": (src_t, (K, n_cols), torch.float32),
        "nbr_t": (nbr_t, (nbr_t.shape[0], n), torch.int32),
        "out": (out, (K, n), torch.float32),
    }, src_t.device)
    err = lib.fdt_neighbor_sum(src_t.data_ptr(), n_cols, nbr_t.data_ptr(),
                               nbr_t.shape[0], n, K, out.data_ptr(), stream)
    _raise_on_launch_error(lib, err, "neighbor_sum")
    return out


def neighbor_sum(src_t: torch.Tensor, nbr_t: torch.Tensor) -> torch.Tensor:
    """Sum of source columns over each spot's padded neighbour list.

    ``src_t``: (K, n_cols); ``nbr_t``: (D, n) indices, one row per degree
    slot. An index below n_cols reads that column and an index of n_cols
    reads +0.0, so a (K, n) carry with padding n needs no copy, and a
    buffer that carries its own zero column reads it. The sum runs one
    slot at a time, slot 0 first, as the JAX ``neighbor_sum`` does.
    Returns (K, n). On a CUDA f32 carry (:func:`neighbor_sum_kernel_takes`)
    this is one launch of the hand-written ``neighbor_sum_kernel``
    (``csrc/cd_block_sweep.cu``), bitwise the plain loop; ``nbr_t`` must
    be int32 and contiguous, and it raises if it cannot launch. Every
    other carry runs :func:`neighbor_sum_reference`.
    ``neighbor_sum.launches`` counts the launches, ``.card_launches`` them
    by the card's index.
    """
    if not neighbor_sum_kernel_takes(src_t):
        return neighbor_sum_reference(src_t, nbr_t)
    from flashdeconv_tpu_torch.ops import _build

    out = src_t.new_empty((src_t.shape[0], nbr_t.shape[-1]))
    with _build.launch_stream(src_t, nbr_t, out) as stream:
        neighbor_sum_launch(_build.load("cd_block_sweep"), stream, src_t,
                            nbr_t, out)
    neighbor_sum.launches += 1
    neighbor_sum.card_launches[src_t.device.index] += 1
    return out


neighbor_sum.launches = 0
neighbor_sum.card_launches = collections.Counter()


def gather_neighbor_sums(beta_t: torch.Tensor, nbr_t: torch.Tensor,
                         overflow=None) -> torch.Tensor:
    """The neighbour sums of the (D, n) table ``nbr_t`` (padding == n) over
    the (K, n) carry ``beta_t``, plus the overflow hubs' sums
    (:func:`add_overflow`; the same padding), (K, n)."""
    return add_overflow(neighbor_sum(beta_t, nbr_t), beta_t, overflow)


def overflow_table(ov_src: np.ndarray, ov_dst: np.ndarray, n_spots: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Group the overflow edges of a degree-capped table by spot.

    ``ov_src``/``ov_dst`` are the edge lists of
    :func:`flashdeconv_tpu_torch.utils.graph.adjacency_to_padded_capped`
    (spot, neighbour). Returns ``(rows, table)``: the (H,) distinct spots
    that have overflow edges, ascending, and an (S, H) table of their
    neighbours in edge order, padded with the sentinel ``n_spots``. Summing
    the table slot by slot and adding each spot's sum into its one row is
    deterministic, where a scatter-add of repeated rows on the card is not.
    """
    order = np.argsort(ov_src, kind="stable")
    rows, counts = np.unique(ov_src, return_counts=True)
    starts = np.cumsum(counts) - counts
    table = np.full((int(counts.max()) if rows.size else 0, rows.size),
                    n_spots, dtype=np.int64)
    slot = np.arange(order.size) - np.repeat(starts, counts)
    table[slot, np.repeat(np.arange(rows.size), counts)] = ov_dst[order]
    return rows.astype(np.int64), table


def overflow_sum(beta_t: torch.Tensor, ov_table_t: torch.Tensor
                 ) -> torch.Tensor:
    """Neighbour sums over the overflow edges of the hub spots, (K, H):
    the (S, H) table of :func:`overflow_table` summed slot by slot by
    :func:`neighbor_sum` (on the card an int32 table)."""
    return neighbor_sum(beta_t, ov_table_t)


def add_overflow(ns_t, beta_t, overflow) -> torch.Tensor:
    """``ns_t`` plus the overflow sums in the hub spots' columns, each
    column written once."""
    if overflow is None:
        return ns_t
    rows, table = overflow
    ns_t[:, rows] = ns_t[:, rows] + overflow_sum(beta_t, table)
    return ns_t


def neighbor_sum_banded(beta_t: torch.Tensor, offsets: Tuple[int, ...],
                        masks: torch.Tensor, rest_t: torch.Tensor
                        ) -> torch.Tensor:
    """Neighbour sum over a banded + remainder decomposition, (K, n).

    Each band ``off`` adds ``masks[u] * beta_t[:, j + off]`` over the
    columns where ``j + off`` is in range (the mask is 0 elsewhere), bands
    in ``offsets`` order from a zero start, as the JAX
    ``neighbor_sum_banded`` and the fused kernel do; the remainder's padded
    table ``rest_t`` (R, n), R possibly 0, adds after the bands.
    ``masks``: (U, n) f32 0/1.
    """
    ns = _banded_neighbor_sum(beta_t, masks, offsets, 0)
    if rest_t.shape[0]:
        ns += neighbor_sum(beta_t, rest_t)
    return ns


def build_fused_rest_tables(rest_nbr_idx: np.ndarray, sentinel: int, h: int,
                            block: int):
    """The fused tier's tables of its rest edges (the graph's remainder off
    the bands, spilled sparse bands included).

    ``rest_nbr_idx``: the (n_solve, R) padded neighbour table of the rest
    edges (:func:`flashdeconv_tpu_torch.utils.graph.adjacency_to_padded`,
    padding rows appended), padding slots == ``sentinel``. Returns
    ``(touched, slot_cols)`` int32 host arrays: the (T,) data columns that
    have a rest edge, padded to a multiple of 128 by repeating the last one
    (each repeat writes the same value, so the update stays deterministic),
    and the (R, T) carry columns each slot reads (data column + ``h *
    block``; the sentinel reads column 0, a zero column of the carry's left
    pad). ``(None, None)`` when the table has no edge. The JAX package's
    ``build_fused_rest_tables``, unchanged.
    """
    t = np.asarray(rest_nbr_idx)
    touched = np.flatnonzero((t != sentinel).any(axis=1))
    if touched.size == 0:
        return None, None
    pad = (-touched.size) % 128
    touched_p = np.concatenate(
        [touched, np.full(pad, touched[-1], dtype=touched.dtype)]
    ).astype(np.int32)
    slots = t[touched_p]                          # (T, R)
    cols = np.where(
        slots == sentinel, 0, slots + h * block
    ).astype(np.int32).T                          # (R, T)
    return touched_p, np.ascontiguousarray(cols)


def rest_ns_update(ns_rest: torch.Tensor, carry_ext_t: torch.Tensor,
                   touched: torch.Tensor, slot_cols: torch.Tensor
                   ) -> torch.Tensor:
    """Refresh the rest-edge neighbour sums ``ns_rest`` (K, n_solve) in
    place from the fused carry, at the touched columns only; returns it.

    The sums run one slot at a time, slot 0 first, in the order of
    :func:`neighbor_sum`, so the fused sweep with this input is bitwise the
    unfused banded sweep with the same rest table. ``touched`` (T,) int64
    and ``slot_cols`` (R, T) come from :func:`build_fused_rest_tables`. The
    other columns keep what they hold (+0.0 from the solve's start). Plain
    PyTorch, as the JAX package's is XLA.
    """
    vals = torch.index_select(carry_ext_t, 1, slot_cols[0])
    for s in range(1, slot_cols.shape[0]):
        vals += torch.index_select(carry_ext_t, 1, slot_cols[s])
    return ns_rest.index_copy_(1, touched, vals)


def coordinate_descent_block_reference(
    beta_t, Xty_t, XtX, ns_t, inv_den_t, lambda_, rho,
    out: Optional[torch.Tensor] = None,
):
    """Plain PyTorch version of the coordinate-descent kernel: :func:`gs_pass`
    on the given neighbour sums. Returns ``(beta (into out when given),
    max_diff, max_abs)``, the statistics as 0-d tensors."""
    beta = gs_pass(beta_t, Xty_t, XtX, ns_t, inv_den_t, lambda_, rho)
    if out is None:
        out = torch.empty_like(beta_t)
    out.copy_(beta)
    return (out, *sweep_stats(beta, beta_t))


def _check_cd_operands(beta_t, Xty_t, XtX, ns_t, inv_den_t, out):
    K, n = beta_t.shape
    if K > KERNEL_MAX_K:
        raise ValueError(f"the coordinate-descent kernel takes K <= "
                         f"{KERNEL_MAX_K}, got K = {K}")
    expect = {
        "beta_t": (beta_t, (K, n)), "Xty_t": (Xty_t, (K, n)),
        "XtX": (XtX, (K, K)), "ns_t": (ns_t, (K, n)),
        "inv_den_t": (inv_den_t, (K, n)), "out": (out, (K, n)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != beta_t.device:
            raise ValueError(f"{name} is on {t.device}, beta on "
                             f"{beta_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out.data_ptr() == beta_t.data_ptr():
        raise ValueError("the sweep is Jacobi across spots: out must not "
                         "be the input beta")


def cd_sweep_launch(lib, stream: int, beta_t, Xty_t, XtX, ns_t, inv_den_t,
                    lambda_, rho, out) -> torch.Tensor:
    """One call of ``fdt_cd_block_sweep`` of ``lib`` on ``stream``; returns
    the (2, blocks) partials of the two statistics. The operands are
    checked by the caller."""
    K, n = beta_t.shape
    partials = beta_t.new_empty((2, lib.fdt_cd_block_sweep_blocks(n, K)))
    err = lib.fdt_cd_block_sweep(
        beta_t.data_ptr(), out.data_ptr(), Xty_t.data_ptr(),
        ns_t.data_ptr(), inv_den_t.data_ptr(), XtX.data_ptr(), K, n,
        f32(lambda_), f32(rho), partials.data_ptr(), stream,
    )
    _raise_on_launch_error(lib, err, "cd_block_sweep")
    return partials


def _coordinate_descent_block_cuda(beta_t, Xty_t, XtX, ns_t, inv_den_t,
                                   lambda_, rho, out):
    from flashdeconv_tpu_torch.ops import _build

    lib = _build.load("cd_block_sweep")
    with _build.launch_stream(beta_t, Xty_t, XtX, ns_t, inv_den_t,
                              out) as stream:
        partials = cd_sweep_launch(lib, stream, beta_t, Xty_t, XtX, ns_t,
                                   inv_den_t, lambda_, rho, out)
    coordinate_descent_block.card_launches[beta_t.device.index] += 1
    if beta_t.shape[0] > REGISTER_PASS_MAX_K:
        coordinate_descent_block.large_k_launches += 1
    else:
        coordinate_descent_block.launches += 1
    if beta_t.shape[0] > WIDE_ABOVE_K:
        coordinate_descent_block.wide_launches += 1
    stats = torch.amax(partials, dim=1)
    return out, stats[0], stats[1]


def coordinate_descent_block(
    beta_t: torch.Tensor,
    Xty_t: torch.Tensor,
    XtX: torch.Tensor,
    ns_t: torch.Tensor,
    inv_den_t: torch.Tensor,
    lambda_,
    rho,
    out: Optional[torch.Tensor] = None,
):
    """The Gauss-Seidel pass of every spot given its neighbour sums.

    Counterpart of the JAX ``coordinate_descent_pallas``: ``beta_t``,
    ``Xty_t``, ``ns_t``, ``inv_den_t`` (K, n) f32, ``XtX`` (K, K) f32, all
    contiguous; ``out`` an optional (K, n) buffer distinct from ``beta_t``.
    Returns ``(new beta, max_diff, max_abs)``, the statistics as 0-d f32
    tensors on beta's device. On a CUDA tensor this launches the
    hand-written kernel ``csrc/cd_block_sweep.cu`` (and raises if it
    cannot); on a CPU tensor it runs
    :func:`coordinate_descent_block_reference`.
    ``coordinate_descent_block.launches`` counts the launches of the
    kernel's register form (K <= ``REGISTER_PASS_MAX_K`` = 32),
    ``.large_k_launches`` those of its panel form above,
    ``.wide_launches``, besides, those at K > ``WIDE_ABOVE_K`` = 256 (the
    tile pass's one-block-an-SM instances), ``.card_launches`` all of them
    by the card's index.
    """
    if out is None:
        out = torch.empty_like(beta_t)
    _check_cd_operands(beta_t, Xty_t, XtX, ns_t, inv_den_t, out)
    if beta_t.device.type == "cuda":
        return _coordinate_descent_block_cuda(
            beta_t, Xty_t, XtX, ns_t, inv_den_t, lambda_, rho, out,
        )
    if beta_t.device.type == "cpu":
        return coordinate_descent_block_reference(
            beta_t, Xty_t, XtX, ns_t, inv_den_t, lambda_, rho, out=out,
        )
    raise ValueError(f"no coordinate-descent sweep for device "
                     f"{beta_t.device}")


coordinate_descent_block.launches = 0
coordinate_descent_block.large_k_launches = 0
coordinate_descent_block.wide_launches = 0
coordinate_descent_block.card_launches = collections.Counter()


def _coord_update(beta, r, k: int, Xty_t, XtX, ns_t, lam_nnb, lambda_,
                  rho) -> None:
    """Gauss-Seidel update of coordinate k for every spot at once, in place
    on ``beta`` and the maintained residual ``r`` (both (K, n)): the JAX
    ``_coord_update``. ``lam_nnb`` is ``lambda * degree`` (n,)."""
    old = beta[k]
    diag_k = XtX[k, k]
    # Partial residual without coordinate k's own term, plus the pull
    # toward the neighbour sum; relu(resid - rho) / denom is the
    # soft-thresholded, clamped 1-D minimiser.
    resid = Xty_t[k] - r[k] + diag_k * old + lambda_ * ns_t[k]
    denom = diag_k + lam_nnb
    new = torch.where(denom > 1e-10, torch.clamp_min(resid - rho, 0.0) / denom,
                      torch.zeros_like(old))
    r.addcmul_(XtX[k][:, None], (new - old)[None, :])  # rank-1 refresh
    beta[k] = new


def coordinate_descent(beta_t, Xty_t, XtX, ns_t, nnb, lambda_, rho,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Gauss-Seidel pass over the K coordinates of every spot: the JAX
    package's XLA tier (``coordinate_descent``) on the (K, n) carry, in the
    carry's dtype.

    ``beta_t`` (K, n) is the Jacobi read buffer the neighbour sums ``ns_t``
    (K, n) were formed from; ``nnb`` (n,) the degrees. The residual ``r =
    XtX^T beta`` is formed once (full f32 in f32); coordinate k then moves
    for all spots at once (:func:`_coord_update`): ``resid = xty_k - r_k +
    diag_k * old + lambda * ns_k`` (in that order), ``new = max(resid -
    rho, 0) / (diag_k + lambda * nnb)`` where the denominator is above
    1e-10 (else 0), and the rank-1 refresh ``r += XtX[k]^T (x) (new -
    old)``. One loop over K (the JAX unrolled / ``fori_loop`` split is an
    XLA compile-time device, one rule). Returns the new beta, written into
    ``out`` (distinct from ``beta_t``) when given. Plain PyTorch: no kernel
    takes f64 or K > ``KERNEL_MAX_K`` (the JAX package's Pallas kernels
    take no f64 and no K > 256).
    """
    if out is None:
        out = torch.empty_like(beta_t)
    beta = out.copy_(beta_t)
    with full_f32_matmul():
        r = XtX.T @ beta_t
    lam_nnb = lambda_ * nnb.reshape(-1).to(beta.dtype)
    for k in range(beta.shape[0]):
        _coord_update(beta, r, k, Xty_t, XtX, ns_t, lam_nnb, lambda_, rho)
    return beta


def gs_pass_fn(XtX: torch.Tensor, nnb: torch.Tensor, lambda_, rho
               ) -> Callable:
    """The Gauss-Seidel pass of the unfused sweeps on these operands, as
    ``fn(beta_t, Xty_t, ns_t, out) -> (beta, max_diff, max_abs)``.

    Where :func:`kernel_takes` the solve (f32, K <= 384) it is kernel #2,
    :func:`coordinate_descent_block`, with the per-solve
    :func:`gs_inv_den` computed here; otherwise :func:`coordinate_descent`,
    whose denominator is formed inside the sweep, as the JAX XLA tier's.
    ``lambda_`` and ``rho`` are the solve's scalars in its dtype.
    """
    if kernel_takes(XtX.dtype, XtX.shape[0]):
        inv_den_t = gs_inv_den(XtX, nnb, lambda_)

        def kernel_pass(beta_t, Xty_t, ns_t, out):
            return coordinate_descent_block(beta_t, Xty_t, XtX, ns_t,
                                            inv_den_t, lambda_, rho, out=out)
        return kernel_pass

    def xla_pass(beta_t, Xty_t, ns_t, out):
        beta = coordinate_descent(beta_t, Xty_t, XtX, ns_t, nnb, lambda_,
                                  rho, out=out)
        return (beta, *sweep_stats(beta, beta_t))
    return xla_pass


def bcd_sweep(beta_t, Xty_t, nbr_t, gs: Callable, overflow=None, out=None):
    """One gather-tier sweep: padded-table neighbour sums (plus the
    overflow hubs' sums), then the pass ``gs`` of :func:`gs_pass_fn`.
    ``overflow``: None or the ``(rows, table)`` of :func:`overflow_table`
    as tensors. Returns ``(beta, max_diff, max_abs)``."""
    ns = gather_neighbor_sums(beta_t, nbr_t, overflow)
    return gs(beta_t, Xty_t, ns, out)


def bcd_sweep_banded(beta_t, Xty_t, offsets, masks, rest_t, gs: Callable,
                     out=None):
    """One unfused banded sweep: :func:`neighbor_sum_banded`, then the
    pass ``gs`` of :func:`gs_pass_fn`. Returns ``(beta, max_diff,
    max_abs)``."""
    ns = neighbor_sum_banded(beta_t, offsets, masks, rest_t)
    return gs(beta_t, Xty_t, ns, out)


# ---------------------------------------------------------------------------
# Objective, the stopping rule, the chunked loop and the one solve of all
# tiers.
# ---------------------------------------------------------------------------

def objective_sums(beta_t, Xty_t, ns_t, nnb):
    """The sums of the objective over the columns of ``beta_t`` (K, n):
    ``(stack([<beta, Xty>, sum deg*|beta|^2, <beta, ns>, |beta|_1]),
    beta beta^T)``. Summed over the shards of a mesh they are the whole
    problem's; :func:`objective_from_sums` forms the objective."""
    cross = torch.sum(beta_t * Xty_t)
    nnb_row = nnb.reshape(1, -1).to(beta_t.dtype)
    deg_term = torch.sum(nnb_row * torch.sum(beta_t * beta_t, dim=0,
                                             keepdim=True))
    adj_term = torch.sum(beta_t * ns_t)
    l1 = torch.sum(torch.abs(beta_t))
    return torch.stack([cross, deg_term, adj_term, l1]), beta_t @ beta_t.T


def objective_from_terms(terms, YtY, lambda_, rho):
    """``0.5*(YtY - 2*cross + quad) + 0.5*lambda*(deg - adj) + rho*l1``
    from the five 0-d tensors ``(cross, deg, adj, l1, quad)``, in their
    dtype and on their device, as a 0-d tensor: ``cross = <beta, Xty>``,
    ``deg = sum deg*|beta|^2``, ``adj = <beta, ns>``, ``l1 = |beta|_1``,
    ``quad = <beta beta^T, XtX>``; Tr(beta^T L beta) expanded without L.
    Both routes of the objective form it here."""
    cross, deg_term, adj_term, l1, quad = terms
    YtY = torch.as_tensor(YtY, dtype=quad.dtype, device=quad.device)
    fidelity = 0.5 * (YtY - 2.0 * cross + quad)
    spatial = 0.5 * scalar(lambda_, quad.dtype) * (deg_term - adj_term)
    return fidelity + spatial + scalar(rho, quad.dtype) * l1


def objective_from_sums(sums, BtB, XtX, YtY, lambda_, rho):
    """The objective (:func:`objective_from_terms`) from
    :func:`objective_sums`, ``quad = sum(BtB * XtX)``, as a 0-d tensor."""
    return objective_from_terms((*sums, torch.sum(BtB * XtX)), YtY, lambda_,
                                rho)


def _objective(beta_t, Xty_t, XtX, YtY, ns_t, nnb, lambda_, rho):
    """The objective on the (K, n) layout, as a 0-d tensor."""
    return objective_from_sums(*objective_sums(beta_t, Xty_t, ns_t, nnb),
                               XtX, YtY, lambda_, rho)


def fused_objective_launch(lib, stream: int, beta_ext_t, Xty_t, XtX, masks,
                           nnb, offsets, h: int, block: int,
                           ns_rest_t=None) -> torch.Tensor:
    """One call of ``fdt_fused_banded_objective`` of ``lib`` on ``stream``;
    returns the (5, blocks) partials of the objective's sums (rows: cross,
    degree, adjacency, L1, quad). The operands are checked by the caller;
    ``ns_rest_t`` None passes a null pointer (no rest input)."""
    K, n_ext = beta_ext_t.shape
    n_solve = Xty_t.shape[1]
    partials = beta_ext_t.new_empty(
        (5, lib.fdt_fused_banded_objective_blocks(n_solve)))
    offs = (ctypes.c_int * len(offsets))(*(int(o) for o in offsets))
    err = lib.fdt_fused_banded_objective(
        beta_ext_t.data_ptr(), n_ext, Xty_t.data_ptr(), masks.data_ptr(),
        nnb.data_ptr(), None if ns_rest_t is None else ns_rest_t.data_ptr(),
        n_solve, XtX.data_ptr(), offs, len(offsets), K, h * block,
        partials.data_ptr(), stream,
    )
    _raise_on_launch_error(lib, err, "fused_banded_objective")
    return partials


def objective_sums_from_partials(partials: torch.Tensor) -> torch.Tensor:
    """The five sums (cross, degree, adjacency, L1, quad) from the kernel's
    (5, blocks) partials: one sum over the blocks in a fixed order, in the
    partials' dtype on their device, then the (5,) result to the host (one
    read of the card, as the caller's ``float()`` of a card tensor would
    be)."""
    return torch.sum(partials, dim=1).cpu()


def fused_banded_objective_sums(beta_ext_t, Xty_t, XtX, masks, nnb,
                                offsets: Tuple[int, ...], h: int, block: int,
                                ns_rest_t=None) -> torch.Tensor:
    """The objective's five sums on a CUDA fused carry by one launch of the
    hand-written kernel ``fused_banded_objective_kernel``
    (``csrc/fused_banded_sweep.cu``): every sum in one pass over the carry,
    the neighbour sums by the sweep kernels' band loader, ``ns_rest_t``
    (K, n_solve), when given, added once after the bands. f32, K <=
    ``OBJECTIVE_KERNEL_MAX_K``; raises otherwise, on a CPU carry and when
    the launch fails. Returns ``(cross, deg, adj, l1, quad)`` as a (5,) f32
    tensor on the host (:func:`objective_sums_from_partials`);
    ``fused_banded_objective.launches`` counts the launches at K <=
    ``REGISTER_PASS_MAX_K``, ``.large_k_launches`` those above,
    ``.card_launches`` both by the card's index."""
    K, n_ext = beta_ext_t.shape
    n_solve = Xty_t.shape[1]
    if K > OBJECTIVE_KERNEL_MAX_K:
        raise ValueError(f"the objective kernel takes K <= "
                         f"{OBJECTIVE_KERNEL_MAX_K}, got K = {K}")
    _check_bands(offsets, h, block)
    expect = {
        "beta_ext_t": (beta_ext_t, (K, n_solve + 2 * h * block),
                       torch.float32),
        "Xty_t": (Xty_t, (K, n_solve), torch.float32),
        "XtX": (XtX, (K, K), torch.float32),
        "masks": (masks, (len(offsets), n_solve), torch.uint8),
        "nnb": (nnb, (n_solve,), torch.float32),
    }
    if ns_rest_t is not None:
        expect["ns_rest_t"] = (ns_rest_t, (K, n_solve), torch.float32)
    _check_layout(expect, beta_ext_t.device)
    from flashdeconv_tpu_torch.ops import _build

    with _build.launch_stream(beta_ext_t, Xty_t, XtX, masks, nnb,
                              ns_rest_t) as stream:
        partials = fused_objective_launch(
            _build.load("fused_banded_sweep"), stream, beta_ext_t, Xty_t,
            XtX, masks, nnb, offsets, h, block, ns_rest_t)
    if K > REGISTER_PASS_MAX_K:
        fused_banded_objective.large_k_launches += 1
    else:
        fused_banded_objective.launches += 1
    fused_banded_objective.card_launches[beta_ext_t.device.index] += 1
    return objective_sums_from_partials(partials)


def fused_banded_objective(beta_ext_t, Xty_t, XtX, YtY, masks, nnb,
                           lambda_, rho, offsets: Tuple[int, ...], h: int,
                           block: int, ns_rest_t=None):
    """The objective on a CUDA fused carry from the kernel's sums
    (:func:`fused_banded_objective_sums`, one launch), formed by
    :func:`objective_from_terms`: a 0-d f32 tensor on the host."""
    return objective_from_terms(
        fused_banded_objective_sums(beta_ext_t, Xty_t, XtX, masks, nnb,
                                    offsets, h, block, ns_rest_t),
        YtY, lambda_, rho)


fused_banded_objective.launches = 0
fused_banded_objective.large_k_launches = 0
fused_banded_objective.card_launches = collections.Counter()


def fused_banded_objective_sums_reference(
    beta_ext_t, Xty_t, XtX, offsets: Tuple[int, ...], masks, h: int,
    block: int, nnb: torch.Tensor, rest_touched=None, rest_slot_cols=None,
) -> torch.Tensor:
    """Plain PyTorch sums ``(cross, deg, adj, l1, quad)`` of the objective
    on the fused carry, a (5,) tensor on the carry's device: the banded
    neighbour sums (:func:`_banded_neighbor_sum`, masks cast to the
    carry's dtype), the rest edges' sums added after the bands, then
    :func:`objective_sums` and ``quad = sum(BtB * XtX)``."""
    pad = h * block
    n_solve = Xty_t.shape[1]
    ns_t = _banded_neighbor_sum(beta_ext_t, masks.to(Xty_t.dtype), offsets,
                                pad)
    if rest_touched is not None:
        ns_t = ns_t + rest_ns_update(torch.zeros_like(ns_t), beta_ext_t,
                                     rest_touched, rest_slot_cols)
    sums, BtB = objective_sums(beta_ext_t[:, pad:pad + n_solve], Xty_t, ns_t,
                               nnb)
    return torch.cat([sums, torch.sum(BtB * XtX).reshape(1)])


def objective_terms_banded_fused_reference(
    beta_ext_t, Xty_t, XtX, YtY, offsets: Tuple[int, ...], masks,
    lambda_, rho, h: int, block: int, nnb: torch.Tensor,
    rest_touched=None, rest_slot_cols=None,
):
    """Plain PyTorch objective on the fused carry, as a 0-d tensor on the
    carry's device: :func:`objective_from_terms` of
    :func:`fused_banded_objective_sums_reference`."""
    return objective_from_terms(
        fused_banded_objective_sums_reference(
            beta_ext_t, Xty_t, XtX, offsets, masks, h, block, nnb,
            rest_touched, rest_slot_cols),
        YtY, lambda_, rho)


def objective_terms_banded_fused(
    beta_ext_t, Xty_t, XtX, YtY, offsets: Tuple[int, ...], masks,
    lambda_, rho, h: int, block: int, nnb: torch.Tensor,
    rest_touched=None, rest_slot_cols=None,
):
    """Objective on the fused carry, as a 0-d f32 tensor, with the degree
    ``nnb`` (n_solve,); the rest tables, when given, add the rest edges'
    sums after the bands. A CUDA f32 carry with K <=
    ``OBJECTIVE_KERNEL_MAX_K`` takes :func:`fused_banded_objective` (one
    launch of the kernel; the rest sums from :func:`rest_ns_update`), its
    result on the host; every other carry (the CPU, K > 56, f64)
    :func:`objective_terms_banded_fused_reference`."""
    if (beta_ext_t.device.type == "cuda" and beta_ext_t.dtype == torch.float32
            and beta_ext_t.shape[0] <= OBJECTIVE_KERNEL_MAX_K):
        ns_rest = None if rest_touched is None else rest_ns_update(
            torch.zeros_like(Xty_t), beta_ext_t, rest_touched, rest_slot_cols)
        return fused_banded_objective(
            beta_ext_t, Xty_t, XtX, YtY, masks, nnb.reshape(-1), lambda_,
            rho, offsets, h, block, ns_rest_t=ns_rest)
    return objective_terms_banded_fused_reference(
        beta_ext_t, Xty_t, XtX, YtY, offsets, masks, lambda_, rho, h, block,
        nnb, rest_touched=rest_touched, rest_slot_cols=rest_slot_cols)


def objective_terms(beta_t, Xty_t, XtX, YtY, nbr_t, nnb, lambda_, rho,
                    overflow=None):
    """Objective of the gather tier (padded table and overflow hubs)."""
    ns_t = gather_neighbor_sums(beta_t, nbr_t, overflow)
    return _objective(beta_t, Xty_t, XtX, YtY, ns_t, nnb, lambda_, rho)


def objective_terms_banded(beta_t, Xty_t, XtX, YtY, offsets, masks, rest_t,
                           nnb, lambda_, rho):
    """Objective of the unfused banded tier."""
    ns_t = neighbor_sum_banded(beta_t, offsets, masks, rest_t)
    return _objective(beta_t, Xty_t, XtX, YtY, ns_t, nnb, lambda_, rho)


def converge(sweep: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
             tol: float, max_iter: int, dtype: torch.dtype
             ) -> Tuple[int, float]:
    """The one stopping rule of every tier and mesh: ``sweep()`` (one
    sweep, returning its ``(max_diff, max_abs)``) until ``max_diff /
    (max_abs + 1e-10) < tol`` in the solve ``dtype``, as the JAX loop
    does, or ``max_iter`` sweeps; the sweep that meets the rule counts.
    Each sweep and its one host read is the span
    ``flashdeconv.solve.sweep``. Returns ``(n_iterations, rel_change)``."""
    tol_c = scalar(tol, dtype)
    it, rel = 0, float("inf")
    while it < max_iter and rel >= tol_c:
        with span("flashdeconv.solve.sweep"):
            rel = rel_change(*sweep())
        it += 1
    return it, rel


def converge_loop(
    sweep_fn: Callable, carry: torch.Tensor, tol: float, max_iter: int,
) -> Tuple[torch.Tensor, int, float]:
    """Sweeps of ``sweep_fn(carry, out) -> (new carry, max_diff, max_abs)``
    under :func:`converge`'s rule, in the carry's dtype. The loop
    ping-pongs between ``carry`` and one second buffer allocated here, so
    ``carry`` is overwritten from the second sweep on (it saves a
    carry-sized buffer). Returns ``(carry, n_iterations, rel_change)``.
    """
    state = [carry, torch.empty_like(carry)]

    def sweep():
        new, max_diff, max_abs = sweep_fn(*state)
        state[0], state[1] = new, state[0]
        return max_diff, max_abs

    it, rel = converge(sweep, tol, max_iter, carry.dtype)
    return state[0], it, rel


def rel_change(max_diff: torch.Tensor, max_abs: torch.Tensor) -> float:
    """The stopping statistic ``max_diff / (max_abs + 1e-10)``, formed in
    the statistics' dtype on their device, as a Python float (one read)."""
    return (max_diff / (max_abs + 1e-10)).item()


def run_prepared_solve(
    run_chunk: Callable[[int], Tuple[int, float]],
    eval_objective: Callable[[], torch.Tensor],
    max_iter: int,
    tol: float,
    verbose: bool,
    dtype: torch.dtype,
) -> Tuple[int, float, bool, List[float]]:
    """The one chunked solve loop of every tier and mesh.

    ``run_chunk(n)`` runs up to ``n`` sweeps (:func:`converge`) and returns
    ``(sweeps run, rel_change)``; ``eval_objective()`` is the objective of
    the current state, each call the span ``flashdeconv.solve.objective``.
    Without ``verbose`` the sweeps run as one chunk (a NaN statistic ends
    it, as it ends the JAX one-program loop), then the objective; with it
    in chunks that end after sweeps 0, 10, 20, ... (the reference's
    cadence) and at the converged sweep, each objective printed. Returns
    ``(n_iterations, rel_change, converged, objectives)``,
    ``objectives[-1]`` the final objective.
    """
    tol_c = scalar(tol, dtype)
    objectives: List[float] = []
    n_iter, rel = 0, float("inf")
    chunk = 1 if verbose else max_iter
    while n_iter < max_iter and not rel < tol_c:
        done, rel = run_chunk(min(chunk, max_iter - n_iter))
        n_iter += done
        chunk = 10
        with span("flashdeconv.solve.objective"):
            objectives.append(float(eval_objective()))
        if not verbose:
            break
        print(f"Iteration {n_iter - 1}: objective = {objectives[-1]:.6f}, "
              f"rel_change = {rel:.6e}")
    converged = bool(rel < tol_c)
    if verbose and converged:
        print(f"Converged at iteration {n_iter - 1}")
    return n_iter, rel, converged, objectives


def bcd_iterate_banded_fused(
    carry0, Xty_t, XtX, masks, nnb, lambda_, rho, tol, max_iter: int,
    offsets: Tuple[int, ...], h: int, block: int,
    rest_touched=None, rest_slot_cols=None,
):
    """Fused solve loop on the transposed padded carry; the reciprocal
    denominator is computed once per solve from the degree vector ``nnb``.
    ``rest_touched`` / ``rest_slot_cols`` (:func:`build_fused_rest_tables`,
    as tensors) turn on the rest stream: a (K, n_solve) ``ns_rest`` buffer,
    zero at the start, whose touched columns :func:`rest_ns_update`
    refreshes from each sweep's input carry (Jacobi, like the bands) on the
    launch's stream before the launch that reads it. ``carry0`` is
    overwritten (see :func:`converge_loop`). Returns ``(carry,
    n_iterations, rel_change)``."""
    inv_den_t = gs_inv_den(XtX, nnb, lambda_)
    ns_rest = None if rest_touched is None else torch.zeros_like(Xty_t)

    def sweep(c, out):
        if ns_rest is not None:
            rest_ns_update(ns_rest, c, rest_touched, rest_slot_cols)
        return fused_banded_sweep(c, Xty_t, XtX, masks, inv_den_t, lambda_,
                                  rho, offsets, h, block, out=out,
                                  ns_rest_t=ns_rest)

    return converge_loop(sweep, carry0, tol, max_iter)


def bcd_iterate(beta0_t, Xty_t, XtX, nbr_t, nnb, lambda_, rho, tol,
                max_iter: int, overflow=None):
    """Gather-tier solve loop on the (K, n) carry ``beta0_t`` (overwritten,
    see :func:`converge_loop`), its pass chosen by :func:`gs_pass_fn`.
    Returns ``(beta_t, n_iterations, rel_change)``."""
    gs = gs_pass_fn(XtX, nnb, lambda_, rho)
    return converge_loop(
        lambda b, out: bcd_sweep(b, Xty_t, nbr_t, gs, overflow=overflow,
                                 out=out),
        beta0_t, tol, max_iter,
    )


def bcd_iterate_banded(beta0_t, Xty_t, XtX, offsets, masks, rest_t, nnb,
                       lambda_, rho, tol, max_iter: int):
    """Unfused banded solve loop on the (K, n) carry ``beta0_t``
    (overwritten), its pass chosen by :func:`gs_pass_fn`. Returns
    ``(beta_t, n_iterations, rel_change)``."""
    gs = gs_pass_fn(XtX, nnb, lambda_, rho)
    return converge_loop(
        lambda b, out: bcd_sweep_banded(b, Xty_t, offsets, masks, rest_t,
                                        gs, out=out),
        beta0_t, tol, max_iter,
    )


@dataclasses.dataclass
class Tier:
    """The device operands of a prepared solve, shared by every tier:
    ``Xty_t`` (K, n_solve), ``XtX`` (K, K), the degrees ``nnb`` (n_solve,)
    and the objective's constant ``YtY``, all in the solve's dtype. A tier
    adds its graph and says how beta is carried; :func:`fused_solve`
    drives any of them. ``uses_kernel``: whether its sweeps launch a kernel
    (f32, K <= 384) or run :func:`coordinate_descent` (the unfused tiers
    take both; the fused tier only the first)."""

    Xty_t: torch.Tensor
    XtX: torch.Tensor
    nnb: torch.Tensor
    YtY: float

    @property
    def uses_kernel(self) -> bool:
        return kernel_takes(self.XtX.dtype, self.XtX.shape[0])

    def carry(self, beta0: torch.Tensor) -> torch.Tensor:
        """(n_solve, K) beta -> the tier's carry."""
        return beta0.T.contiguous()

    def beta(self, carry: torch.Tensor) -> torch.Tensor:
        """The carry -> (n_solve, K) beta (a view)."""
        return carry.T


@dataclasses.dataclass
class FusedBandedTier(Tier):
    """Banded graph on the fused kernel: uint8 masks (U, n_solve),
    offsets, the carry's pad of ``h`` blocks of ``block`` spots on each
    side and, for a small remainder of rest edges, the rest stream's
    ``rest_touched`` (T,) and ``rest_slot_cols`` (R, T) int64 tables
    (:func:`build_fused_rest_tables`; None without rest edges)."""

    masks: torch.Tensor
    offsets: Tuple[int, ...]
    h: int
    block: int
    rest_touched: Optional[torch.Tensor] = None
    rest_slot_cols: Optional[torch.Tensor] = None

    def carry(self, beta0):
        return to_fused_carry(beta0, self.h, self.block)

    def beta(self, carry):
        return from_fused_carry(carry, self.h, self.block)

    def iterate(self, carry, lambda_, rho, tol, max_iter):
        return bcd_iterate_banded_fused(
            carry, self.Xty_t, self.XtX, self.masks, self.nnb, lambda_, rho,
            tol, max_iter, self.offsets, self.h, self.block,
            rest_touched=self.rest_touched,
            rest_slot_cols=self.rest_slot_cols,
        )

    def objective(self, carry, lambda_, rho):
        return objective_terms_banded_fused(
            carry, self.Xty_t, self.XtX, self.YtY, self.offsets, self.masks,
            lambda_, rho, self.h, self.block, nnb=self.nnb,
            rest_touched=self.rest_touched,
            rest_slot_cols=self.rest_slot_cols,
        )

    def unfused(self) -> "BandedTier":
        """The unfused banded tier on the same operands and decomposition:
        f32 masks, and the int32 rest table (R, n_solve) rebuilt from the
        rest stream's tables (sentinel n_solve, as :func:`neighbor_sum`
        takes it). Its sweeps are bitwise this tier's.
        """
        n_solve = self.Xty_t.shape[1]
        rest = torch.full((0, n_solve), n_solve, dtype=torch.int32,
                          device=self.Xty_t.device)
        if self.rest_touched is not None:
            cols = self.rest_slot_cols
            rest = torch.full((cols.shape[0], n_solve), n_solve,
                              dtype=torch.int32, device=cols.device)
            rest[:, self.rest_touched] = torch.where(
                cols == 0, n_solve, cols - self.h * self.block).to(
                    torch.int32)
        return BandedTier(Xty_t=self.Xty_t, XtX=self.XtX, nnb=self.nnb,
                          YtY=self.YtY, masks=self.masks.float(),
                          offsets=self.offsets, rest=rest)


@dataclasses.dataclass
class BandedTier(Tier):
    """Banded graph the fused tier does not take: f32 masks (U, n),
    offsets, and the remainder's padded int32 table ``rest`` (R, n), R >=
    0, sentinel n."""

    masks: torch.Tensor
    offsets: Tuple[int, ...]
    rest: torch.Tensor

    def iterate(self, carry, lambda_, rho, tol, max_iter):
        return bcd_iterate_banded(
            carry, self.Xty_t, self.XtX, self.offsets, self.masks, self.rest,
            self.nnb, lambda_, rho, tol, max_iter,
        )

    def objective(self, carry, lambda_, rho):
        return objective_terms_banded(
            carry, self.Xty_t, self.XtX, self.YtY, self.offsets, self.masks,
            self.rest, self.nnb, lambda_, rho,
        )


@dataclasses.dataclass
class GatherTier(Tier):
    """Any graph: the padded int32 neighbour table ``nbr`` (D, n),
    sentinel n, and, when the degree cap binds, the ``overflow`` ``(rows,
    table)`` of the hubs (int64 rows, an int32 table)."""

    nbr: torch.Tensor
    overflow: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def iterate(self, carry, lambda_, rho, tol, max_iter):
        return bcd_iterate(
            carry, self.Xty_t, self.XtX, self.nbr, self.nnb, lambda_, rho,
            tol, max_iter, overflow=self.overflow,
        )

    def objective(self, carry, lambda_, rho):
        return objective_terms(
            carry, self.Xty_t, self.XtX, self.YtY, self.nbr, self.nnb,
            lambda_, rho, overflow=self.overflow,
        )


def fused_solve(
    beta0: Optional[torch.Tensor], tier: Tier, inv_perm, lambda_, rho, tol,
    max_iter: int, n_spots: int, verbose: bool = False,
):
    """The whole solve of any tier: init, :func:`run_prepared_solve` over
    the tier's sweeps and objective, un-pad and un-permute — the
    counterpart of the JAX ``fused_solve_program`` (fused tier) and
    ``solve_program`` (gather and unfused banded tiers) and, with
    ``verbose``, of their chunked verbose loop. ``beta0`` is None (uniform
    1/K over the first ``n_spots`` columns) or an (n_solve, K) tensor;
    ``inv_perm`` is None (identity) or an (n_spots,) index tensor.
    Returns ``(beta (n_spots, K), n_iterations, rel_change, converged,
    objectives)``, beta on the operands' device and ``objectives[-1]`` the
    final objective.
    """
    with full_f32_matmul():
        if beta0 is None:
            beta0 = uniform_beta0(tier.Xty_t, n_spots)
        carry = tier.carry(beta0)

        def run_chunk(n):
            nonlocal carry
            carry, done, rel = tier.iterate(carry, lambda_, rho, tol, n)
            return done, rel

        n_iter, rel, converged, objectives = run_prepared_solve(
            run_chunk, lambda: tier.objective(carry, lambda_, rho),
            max_iter, tol, verbose, tier.Xty_t.dtype)
    beta = tier.beta(carry)[:n_spots]
    if inv_perm is not None:
        beta = beta.index_select(0, inv_perm)
    return beta, n_iter, rel, converged, objectives
