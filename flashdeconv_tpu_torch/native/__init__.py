"""Native (C++) host kernels for the O(nnz) CSR pipeline stages.

The port's own copy of :mod:`flashdeconv_tpu.native`: ``host_kernels.cpp``
is copied whole, and this module binds every kernel the JAX module binds.
The code is unchanged apart from where the library is built.

The TPU owns the solve; the host owns single-pass CSR reductions (HVG
moments, CountSketch projection, row sums, the log_cpm transform, column
subset) that numpy runs at a fraction of memory bandwidth (per-block
temporaries, bincount index conversion, GIL-bounded threading).
``host_kernels.cpp`` fuses each pass and threads it with deterministic
block-ordered reduction; kernels without cross-row accumulation are
bit-identical to the numpy/scipy implementations they replace (see the
.cpp header for the exact per-kernel contract).

Build/load strategy (no pip, no pybind11):

* the C++ source ships inside the package;
* on first use it is compiled with the system ``g++`` into a content-hashed
  shared object under ``flashdeconv_tpu_torch/ops/build/native/`` (beside
  the CUDA kernels' build, git-ignored) and loaded via ctypes;
* if compilation fails, ``g++`` is missing, or the libm ``log1p`` self-test
  diverges from numpy by more than 1 ULP, callers transparently fall back
  to the pure-numpy paths (:func:`exact_log1p_available` reports whether
  the match is bit-for-bit on this platform).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).with_name("host_kernels.cpp")
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_log1p_matches_numpy = False
_log1pf_matches_numpy = False
_log1p_exact = False


def _cache_dir() -> Path:
    return Path(__file__).resolve().parents[1] / "ops" / "build" / "native"


def _compile(src: Path, out: Path) -> bool:
    """Compile the kernel library; atomic rename so concurrent processes
    never load a half-written .so."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(
        dir=out.parent, suffix=".so", delete=False
    ) as tmp:
        tmp_path = Path(tmp.name)
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(src), "-o", str(tmp_path),
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=120
        )
    except (OSError, subprocess.TimeoutExpired):
        tmp_path.unlink(missing_ok=True)
        return False
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        return False
    tmp_path.replace(out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _log1p_matches_numpy, _log1p_exact
    global _log1pf_matches_numpy
    if _load_attempted:
        return _lib
    _load_attempted = True
    try:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _cache_dir() / f"host_kernels-{digest}.so"
        if not so.exists() and not _compile(_SRC, so):
            return None
        lib = ctypes.CDLL(str(so))
    except Exception:
        return None

    # log1p self-test: every log1p-bearing kernel is enabled only when
    # the toolchain's log1p agrees with numpy's float64 log1p to within
    # 1 ULP (numpy >= 2.0 dispatches a SIMD log1p whose results in the
    # ~1e3-1e4 range — exactly the CPM*1e4 values these kernels see —
    # differ from glibc's scalar one by at most the last bit; both are
    # correctly-rounded-or-adjacent). Consequence: native log1p VALUES are
    # within 1 ULP of the numpy expressions they replace, bitwise equal
    # iff `exact_log1p_available()`; fused and staged NATIVE kernels are
    # always mutually bit-identical (same libm); every path is
    # individually deterministic. The gate guards against a genuinely
    # divergent libm.
    try:
        rng = np.random.default_rng(0)
        x = np.concatenate(
            [rng.random(4096) * 1e4, rng.random(4096) * 1e-8, [0.0, 1.0]]
        )
        out = np.empty_like(x)
        lib.log1p_buffer(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(x.size),
        )
        ulp_diff = np.abs(
            out.view(np.int64) - np.log1p(x).view(np.int64)
        )
        _log1p_matches_numpy = bool(ulp_diff.max() <= 1)
        _log1p_exact = bool(ulp_diff.max() == 0)
    except Exception:
        _log1p_matches_numpy = False
        _log1p_exact = False

    # Self-test for the float32 instantiations (fused project/xty and
    # log1p_cpm_transform), which — like the f32 moments kernels — compute
    # log1p in double precision and round once to f32 (vectorized 8-wide
    # with a bit-identical scalar replay for tails; see
    # host_kernels.cpp log1p_poly_pos). Two checks:
    # (a) ULP agreement with numpy's float32 log1p (both are
    #     correctly-rounded-or-adjacent, so <= 1 ULP apart);
    # (b) shift-invariance: log1p over x[1:] must equal log1p over x
    #     sliced — this exercises different vector/scalar lane groupings
    #     of the SAME values, proving the per-element function property
    #     that keeps the fused and staged f32 kernels mutually
    #     bit-identical no matter how each batches its spans.
    try:
        x32 = x.astype(np.float32)
        out32 = np.empty_like(x32)
        lib.log1p_buffer_f32(
            x32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(x32.size),
        )
        ulp32 = np.abs(
            out32.view(np.int32).astype(np.int64)
            - np.log1p(x32).view(np.int32).astype(np.int64)
        )
        x32s = np.ascontiguousarray(x32[1:])
        out32s = np.empty_like(x32s)
        lib.log1p_buffer_f32(
            x32s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out32s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(x32s.size),
        )
        shift_ok = bool(np.array_equal(out32s, out32[1:]))
        # (c) in-place with degenerate lanes: every production call site
        # runs the batch in place, and degenerate (negative / inf) values
        # must be fixed up from the original input, not from an
        # already-overwritten buffer.
        xdeg = np.asarray(
            [0.5, -0.5, 2.0, np.inf, 1e4, 0.0, 3.0, 7.0, 1.5, -0.25],
            dtype=np.float32,
        )
        ref_deg = np.empty_like(xdeg)
        lib.log1p_buffer_f32(
            xdeg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ref_deg.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(xdeg.size),
        )
        inplace = xdeg.copy()
        lib.log1p_buffer_f32(
            inplace.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            inplace.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int64(inplace.size),
        )
        inplace_ok = bool(np.array_equal(inplace, ref_deg)) and bool(
            np.allclose(ref_deg[:4], np.log1p(xdeg[:4]))
        )
        _log1pf_matches_numpy = (
            bool(ulp32.max() <= 1) and shift_ok and inplace_ok
        )
    except Exception:
        _log1pf_matches_numpy = False

    _lib = lib
    return _lib


def available() -> bool:
    """True if the native library compiled and loaded."""
    return _load() is not None


def _log1p_gate_ok(dtype) -> bool:
    """Dtype-aware log1p gate: the f64 kernels call libm log1p; the f32
    fused / transform kernels use the vectorized double-precision log1p
    rounded once to f32 — independent code paths, each enabled only by
    its own self-test against the matching numpy dtype."""
    if dtype == np.float64:
        return _log1p_matches_numpy
    if dtype == np.float32:
        return _log1pf_matches_numpy
    return False


def fused_available(Y) -> bool:
    """True iff the fused subset->log_cpm->CountSketch kernels
    (:func:`fused_log1pcpm_project` / :func:`fused_log1pcpm_xty`) will run
    on ``Y``. This is the ONE authoritative pipeline gate (CSR input, float
    data dtype, per-dtype libm self-test); the kernels return None in
    exactly the complement, so a caller that checks this predicate may
    treat a None from them as an internal error rather than a fallback."""
    from scipy import sparse as _sparse

    return (
        _sparse.isspmatrix_csr(Y)
        and Y.data.dtype in (np.float32, np.float64)
        and _load() is not None
        and _log1p_gate_ok(Y.data.dtype)
    )


def moments_available() -> bool:
    """True if the native HVG-moments kernels may be used (<= 1 ULP libm
    gate; their only consumer is rank-based gene selection)."""
    return _load() is not None and _log1p_matches_numpy


def exact_log1p_available() -> bool:
    """True when libm log1p == numpy log1p bit-for-bit on this platform —
    i.e. the native log1p-bearing kernels reproduce the numpy fallbacks
    exactly rather than to <= 1 ULP. Introspection only; the kernels are
    enabled either way."""
    return _load() is not None and _log1p_exact


def _n_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _is_csr(Y) -> bool:
    """Precondition every CSR-consuming kernel checks FIRST: scipy CSR.

    A CSC matrix also has ``indptr``/``indices``/``data`` attributes, but
    its column pointers passed as row indptr make the C kernels read out
    of bounds (hard segfault, measured); a dense ndarray's ``.data`` is a
    memoryview and fails with an obscure AttributeError. Both must take
    the documented unavailable path (return None) so callers fall back to
    the scipy implementations instead.
    """
    from scipy import sparse as _sparse

    return _sparse.isspmatrix_csr(Y)


def _subset_map(n_genes: int, gene_idx) -> np.ndarray:
    """Dense old-column -> subset-position map (-1 = not selected) — the
    form every subset-fused kernel consumes (ONE home so a future change,
    e.g. a duplicate-gene_idx guard, cannot drift across kernels)."""
    new_col = np.full(n_genes, -1, dtype=np.int32)
    new_col[np.asarray(gene_idx, dtype=np.int64)] = np.arange(
        len(gene_idx), dtype=np.int32
    )
    return new_col


def _check_subset_op(buckets, weights, n_subset: int) -> None:
    """The fused kernels index buckets/weights by SUBSET position with no
    bounds check in the hot loop; catch an undersized operator here
    instead of corrupting the heap."""
    if len(buckets) < n_subset or len(weights) < n_subset:
        raise ValueError(
            f"CountSketch operator covers {len(buckets)} genes but the "
            f"gene subset has {n_subset} — build the operator over the "
            f"subset (buckets/weights are subset-indexed)"
        )


def _csr_buffers(Y) -> Tuple[np.ndarray, np.ndarray, np.ndarray, str]:
    """Contiguous CSR buffers + a dtype-suffix key for the C symbol."""
    indptr = np.ascontiguousarray(Y.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(Y.indices)
    if indices.dtype == np.int32:
        idx_tag = "i32"
    elif indices.dtype == np.int64:
        idx_tag = "i64"
    else:  # unusual index dtype: normalize
        indices = indices.astype(np.int64)
        idx_tag = "i64"
    data = np.ascontiguousarray(Y.data)
    if data.dtype == np.float32:
        tag = f"f32_{idx_tag}"
    elif data.dtype == np.float64:
        tag = f"f64_{idx_tag}"
    else:
        data = data.astype(np.float64)
        tag = f"f64_{idx_tag}"
    return indptr, indices, data, tag


def log1p_cpm_moments(
    Y, scale: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Per-gene (sum, sum-of-squares) of log1p(data * scale[row]) over CSR Y.

    Intermediate precision follows the data dtype, matching the numpy block
    implementation's promotion behavior: float64 data -> f64 products/log1p;
    float32 data -> f32 products/log1p/squares, accumulated in f64 (what
    bincount does with f32 weights).

    Returns None when the native path is unavailable; the caller falls back
    to the numpy block implementation (equivalent results either way).
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    # Gate on the self-test of the log1p path the dispatched kernel
    # actually uses: f32 data runs the f32m kernels (vectorized-poly
    # log1p, _log1pf self-test); everything else promotes to the f64
    # libm kernels (_log1p self-test).
    if not _log1p_gate_ok(
        np.float32 if Y.data.dtype == np.float32 else np.float64
    ):
        return None
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    if data.dtype == np.float32:
        tag = tag.replace("f32", "f32m")  # f32-intermediates kernel
    scale = np.ascontiguousarray(scale, dtype=np.float64)
    out_sum = np.empty(n_genes, dtype=np.float64)
    out_sumsq = np.empty(n_genes, dtype=np.float64)
    fn = getattr(lib, f"log1p_cpm_moments_{tag}")
    fn(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        scale.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(n_genes),
        ctypes.c_int(_n_threads()),
        out_sum.ctypes.data_as(ctypes.c_void_p),
        out_sumsq.ctypes.data_as(ctypes.c_void_p),
    )
    return out_sum, out_sumsq


def log1p_cpm_moments_auto(
    Y,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Self-scaled HVG moments: library sizes fused into the moments pass.

    Equivalent to ``csr_row_sums`` -> ``np.maximum(lib, 1)`` -> ``1e4/lib``
    -> :func:`log1p_cpm_moments` (bit-identical scale per row, same nnz /
    block accumulation order) but one full O(nnz) sweep cheaper. Returns
    None when the native path is unavailable.
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if Y.data.dtype not in (np.float32, np.float64):
        return None
    # Same per-dispatch gate as log1p_cpm_moments.
    if not _log1p_gate_ok(
        np.float32 if Y.data.dtype == np.float32 else np.float64
    ):
        return None
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    if data.dtype == np.float32:
        tag = tag.replace("f32", "f32m")  # f32-intermediates kernel
    out_sum = np.empty(n_genes, dtype=np.float64)
    out_sumsq = np.empty(n_genes, dtype=np.float64)
    fn = getattr(lib, f"log1p_cpm_moments_auto_{tag}")
    fn(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(n_genes),
        ctypes.c_int(_n_threads()),
        out_sum.ctypes.data_as(ctypes.c_void_p),
        out_sumsq.ctypes.data_as(ctypes.c_void_p),
    )
    return out_sum, out_sumsq


def fused_log1pcpm_project(
    Y, gene_idx: np.ndarray, buckets: np.ndarray, weights: np.ndarray,
    sketch_dim: int,
) -> Optional[np.ndarray]:
    """Gene subset -> log_cpm -> CountSketch projection in ONE O(nnz) pass.

    Equivalent to ``csr_column_subset(Y, gene_idx)`` ->
    ``preprocess_data(..., "log_cpm")`` -> ``countsketch_project``:
    bit-identical to that staged NATIVE pipeline (the subset preserves nnz
    order; every float op runs in the same precision and order — see
    ``host_kernels.cpp``), within 1 ULP per log1p value of the pure-numpy
    pipeline — without ever materializing the subset CSR or the
    normalized copy. ``buckets`` /
    ``weights`` are indexed by SUBSET column (position in ``gene_idx``).
    Returns the dense (n_rows, sketch_dim) float64 sketch, or None when
    the native path is unavailable.
    """
    lib = _load()
    if lib is None or not _is_csr(Y) or not _log1p_gate_ok(Y.data.dtype):
        return None
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    new_col = _subset_map(n_genes, gene_idx)
    _check_subset_op(buckets, weights, len(gene_idx))
    buckets = np.ascontiguousarray(buckets, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    out = np.empty((n_rows, sketch_dim), dtype=np.float64)
    fn = getattr(lib, f"fused_log1pcpm_project_{tag}")
    fn(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        new_col.ctypes.data_as(ctypes.c_void_p),
        buckets.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(sketch_dim),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def fused_log1pcpm_xty(
    Y, gene_idx: np.ndarray, buckets: np.ndarray, weights: np.ndarray,
    sketch_dim: int, X_sketch: np.ndarray,
) -> Optional[Tuple[np.ndarray, float]]:
    """Like :func:`fused_log1pcpm_project`, but contracts each row's sketch
    against ``X_sketch`` (K, d) on the fly, returning
    ``(Xty = Y_sketch @ X_sketch.T as (n_rows, K) float64, YtY)`` without
    ever materializing the (n_rows, d) sketch — at atlas scale that is a
    multi-GB write plus a BLAS re-read saved. Per-value log1p/scatter
    semantics are bit-identical to the project kernel; the contractions use
    a fixed deterministic accumulator structure (ULP-level vs a BLAS gemm).
    Returns None when the native path is unavailable.
    """
    ctx = _fused_xty_setup(Y, gene_idx, buckets, weights, X_sketch)
    if ctx is None:
        return None
    n_rows = Y.shape[0]
    out_xty = np.empty((n_rows, ctx["n_types"]), dtype=np.float64)
    yty = _fused_xty_call(ctx, 0, n_rows, sketch_dim, out_xty)
    return out_xty, yty


def _fused_xty_setup(Y, gene_idx, buckets, weights, X_sketch,
                     kind: str = "log1pcpm", colscale=None):
    """Shared argument prep for the fused-Xty kernels; None if unavailable.

    ``kind`` selects the kernel family: "log1pcpm" (subset -> log-CPM ->
    sketch; gated on the per-dtype libm self-test) or "colscale" (subset ->
    per-gene scale -> sketch; no libm, so no gate beyond the library
    loading). For "colscale", ``colscale`` is the per-subset-gene scale in
    the data dtype, or None for the identity (the raw pipeline).
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if kind == "log1pcpm" and not _log1p_gate_ok(Y.data.dtype):
        return None
    # colscale has no libm, but its gate (colscale_available) still
    # requires a float data dtype — keep the kernel's behavior and the
    # gate's verdict agreeing in BOTH directions (no silent int
    # promotion the staged scipy pipeline would not perform).
    if kind == "colscale" and Y.data.dtype not in (np.float32, np.float64):
        return None
    n_genes = Y.shape[1]
    indptr, indices, data, tag = _csr_buffers(Y)
    new_col = _subset_map(n_genes, gene_idx)
    _check_subset_op(buckets, weights, len(gene_idx))
    if kind == "colscale" and colscale is not None:
        colscale = np.ascontiguousarray(colscale, dtype=data.dtype)
    return {
        "fn": getattr(lib, f"fused_{kind}_xty_{tag}"),
        "kind": kind,
        "indptr": indptr,
        "indices": indices,
        "data": data,
        "new_col": new_col,
        "colscale": colscale,
        "buckets": np.ascontiguousarray(buckets, dtype=np.int32),
        "weights": np.ascontiguousarray(weights, dtype=np.float64),
        "Xsk": np.ascontiguousarray(X_sketch, dtype=np.float64),
        "n_types": int(np.asarray(X_sketch).shape[0]),
    }


def _fused_xty_call(ctx, row_start: int, row_end: int, sketch_dim: int,
                    out_xty: np.ndarray) -> float:
    """Run the kernel over rows [row_start, row_end) writing (rows, K)
    into ``out_xty``; returns that range's YtY partial.

    Zero-copy row ranges: the kernel indexes ``data``/``indices`` with the
    ABSOLUTE ``indptr`` values, so an ``indptr[a:b+1]`` view over the
    original buffers addresses exactly rows a..b-1.
    """
    out_yty = np.empty(1, dtype=np.float64)
    args = [
        ctx["indptr"][row_start:row_end + 1].ctypes.data_as(ctypes.c_void_p),
        ctx["indices"].ctypes.data_as(ctypes.c_void_p),
        ctx["data"].ctypes.data_as(ctypes.c_void_p),
        ctx["new_col"].ctypes.data_as(ctypes.c_void_p),
    ]
    if ctx["kind"] == "colscale":
        cs = ctx["colscale"]
        args.append(
            cs.ctypes.data_as(ctypes.c_void_p) if cs is not None else None
        )
    args += [
        ctx["buckets"].ctypes.data_as(ctypes.c_void_p),
        ctx["weights"].ctypes.data_as(ctypes.c_void_p),
        ctx["Xsk"].ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(row_end - row_start),
        ctypes.c_int64(sketch_dim),
        ctypes.c_int64(ctx["n_types"]),
        ctypes.c_int(_n_threads()),
        out_xty.ctypes.data_as(ctypes.c_void_p),
        out_yty.ctypes.data_as(ctypes.c_void_p),
    ]
    ctx["fn"](*args)
    return float(out_yty[0])


#: Default row-chunk size for the streamed fused-Xty pass — also the
#: threshold above which the pipeline streams (core/deconv._fused_xty_feed).
XTY_STREAM_CHUNK_ROWS = 262_144


def fused_log1pcpm_xty_chunks(
    Y, gene_idx: np.ndarray, buckets: np.ndarray, weights: np.ndarray,
    sketch_dim: int, X_sketch: np.ndarray,
    chunk_rows: int = XTY_STREAM_CHUNK_ROWS,
):
    """Chunked variant of :func:`fused_log1pcpm_xty` for streaming consumers.

    Returns a generator of ``(row_start, row_end, xty_chunk, yty_partial)``
    — or None when the native path is unavailable. Per-row Xty values are
    bit-identical to the single-call variant (rows are independent); only
    the YtY partial-sum association differs, and YtY feeds nothing but the
    objective constant. The point of chunking: a pipeline can enqueue each
    chunk's host->device transfer while the kernel computes the next one,
    hiding the (N, K) upload behind the O(nnz) pass.
    """
    ctx = _fused_xty_setup(Y, gene_idx, buckets, weights, X_sketch)
    if ctx is None:
        return None
    return _xty_chunk_gen(ctx, Y.shape[0], sketch_dim, chunk_rows)


def _xty_chunk_gen(ctx, n_rows: int, sketch_dim: int, chunk_rows: int):
    def gen():
        for a in range(0, n_rows, chunk_rows):
            b = min(a + chunk_rows, n_rows)
            out = np.empty((b - a, ctx["n_types"]), dtype=np.float64)
            yty = _fused_xty_call(ctx, a, b, sketch_dim, out)
            yield a, b, out, yty

    return gen()


def colscale_available(Y) -> bool:
    """True iff the fused subset->column-scale->CountSketch kernels
    (:func:`fused_colscale_project` / :func:`fused_colscale_xty` — the
    pearson / raw sparse pipelines) will run on ``Y``: CSR input, float
    data dtype, native library loaded. No libm gate — these kernels contain
    no transcendentals and are bit-identical to the scipy staged pipeline
    they replace. Like :func:`fused_available`, this is the ONE
    authoritative gate: a None from the kernels despite it passing is an
    internal error, not a fallback condition."""
    from scipy import sparse as _sparse

    return (
        _sparse.isspmatrix_csr(Y)
        and Y.data.dtype in (np.float32, np.float64)
        and _load() is not None
    )


def subset_col_mean(Y, gene_idx: np.ndarray) -> Optional[np.ndarray]:
    """Per-gene means of ``Y[:, gene_idx]`` without materializing the subset.

    Bit-identical to ``np.asarray(Y[:, gene_idx].mean(axis=0)).ravel()``
    for float CSR input: scipy's mean multiplies every stored entry by
    ``1.0/n_rows`` in the data dtype FIRST, then column-sums the products
    sequentially in row-major nnz order in the data dtype — the kernel
    replays exactly that association on one thread (the pass is read-bound,
    so single-threading costs little). Returns the (len(gene_idx),) means
    in the data dtype, or None when the native path is unavailable.
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if Y.data.dtype not in (np.float32, np.float64):
        return None
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    new_col = _subset_map(n_genes, gene_idx)
    out = np.empty(len(gene_idx), dtype=data.dtype)
    getattr(lib, f"subset_scaled_col_sums_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        new_col.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_double(1.0 / n_rows if n_rows else 0.0),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(len(gene_idx)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def fused_colscale_project(
    Y, gene_idx: np.ndarray, colscale: Optional[np.ndarray],
    buckets: np.ndarray, weights: np.ndarray, sketch_dim: int,
) -> Optional[np.ndarray]:
    """Gene subset -> per-gene scale -> CountSketch projection in ONE pass.

    The pearson / raw sparse pipelines' analog of
    :func:`fused_log1pcpm_project`: equivalent to
    ``Y[:, gene_idx].multiply(colscale)`` -> ``countsketch_project`` (or
    ``Y[:, gene_idx].astype(float64)`` -> project when ``colscale`` is
    None), and — since no libm is involved — bit-identical to that staged
    *scipy* pipeline, not just the staged native one. ``colscale`` must
    already have the data dtype (the caller owns the promotion rule; see
    ``preprocess_data``'s pearson branch). ``buckets`` / ``weights`` are
    indexed by SUBSET column. Returns the dense (n_rows, sketch_dim)
    float64 sketch, or None when the native path is unavailable.
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if Y.data.dtype not in (np.float32, np.float64):
        return None
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    new_col = _subset_map(n_genes, gene_idx)
    _check_subset_op(buckets, weights, len(gene_idx))
    if colscale is not None:
        colscale = np.ascontiguousarray(colscale, dtype=data.dtype)
    buckets = np.ascontiguousarray(buckets, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    out = np.empty((n_rows, sketch_dim), dtype=np.float64)
    getattr(lib, f"fused_colscale_project_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        new_col.ctypes.data_as(ctypes.c_void_p),
        colscale.ctypes.data_as(ctypes.c_void_p)
        if colscale is not None else None,
        buckets.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(sketch_dim),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def fused_colscale_xty(
    Y, gene_idx: np.ndarray, colscale: Optional[np.ndarray],
    buckets: np.ndarray, weights: np.ndarray, sketch_dim: int,
    X_sketch: np.ndarray,
) -> Optional[Tuple[np.ndarray, float]]:
    """Like :func:`fused_colscale_project`, but contracts each row's sketch
    against ``X_sketch`` (K, d) on the fly — the pearson / raw analog of
    :func:`fused_log1pcpm_xty`, with the same contraction structure and the
    same never-materialize-the-sketch rationale. Returns ``(Xty, YtY)`` or
    None when unavailable."""
    ctx = _fused_xty_setup(Y, gene_idx, buckets, weights, X_sketch,
                           kind="colscale", colscale=colscale)
    if ctx is None:
        return None
    n_rows = Y.shape[0]
    out_xty = np.empty((n_rows, ctx["n_types"]), dtype=np.float64)
    yty = _fused_xty_call(ctx, 0, n_rows, sketch_dim, out_xty)
    return out_xty, yty


def fused_colscale_xty_chunks(
    Y, gene_idx: np.ndarray, colscale: Optional[np.ndarray],
    buckets: np.ndarray, weights: np.ndarray, sketch_dim: int,
    X_sketch: np.ndarray, chunk_rows: int = XTY_STREAM_CHUNK_ROWS,
):
    """Chunked streaming variant of :func:`fused_colscale_xty` (see
    :func:`fused_log1pcpm_xty_chunks` for the streaming rationale and the
    chunk-boundary YtY caveat). Returns a generator of
    ``(row_start, row_end, xty_chunk, yty_partial)`` or None."""
    ctx = _fused_xty_setup(Y, gene_idx, buckets, weights, X_sketch,
                           kind="colscale", colscale=colscale)
    if ctx is None:
        return None
    return _xty_chunk_gen(ctx, Y.shape[0], sketch_dim, chunk_rows)


def csr_row_sums(Y) -> Optional[np.ndarray]:
    """Per-row sums of CSR ``Y`` in the data dtype.

    Bit-identical to ``np.asarray(Y.sum(axis=1)).ravel()`` (scipy computes
    each row sequentially in nnz order in the input dtype; rows are
    independent, so threading cannot change a single bit) but threaded.
    Returns None when the native path is unavailable or the data dtype is
    not float32/float64.
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if Y.data.dtype not in (np.float32, np.float64):
        return None
    n_rows = Y.shape[0]
    indptr = np.ascontiguousarray(Y.indptr, dtype=np.int64)
    data = np.ascontiguousarray(Y.data)
    out = np.empty(n_rows, dtype=data.dtype)
    tag = "f32" if data.dtype == np.float32 else "f64"
    getattr(lib, f"csr_row_sums_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def log1p_cpm_transform(Y, scale: np.ndarray) -> Optional[np.ndarray]:
    """``log1p(Y.data * scale[row])`` in the data dtype, as a new array.

    The sparse log_cpm preprocess map. Element-wise (no accumulation), so
    threading changes nothing; values match the numpy expression
    ``np.log1p(Y.data * np.repeat(scale, np.diff(Y.indptr)))`` to <= 1 ULP
    (bitwise iff :func:`exact_log1p_available`) — provided ``scale``
    already has the data dtype (the caller owns that promotion rule). Returns None when unavailable (same libm/log1p gate as the
    moments kernel).
    """
    lib = _load()
    if (lib is None or not _is_csr(Y)
            or not _log1p_gate_ok(Y.data.dtype)):
        return None
    n_rows = Y.shape[0]
    indptr = np.ascontiguousarray(Y.indptr, dtype=np.int64)
    data = np.ascontiguousarray(Y.data)
    scale = np.ascontiguousarray(scale, dtype=data.dtype)
    out = np.empty_like(data)
    tag = "f32" if data.dtype == np.float32 else "f64"
    getattr(lib, f"log1p_cpm_transform_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        scale.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def sq_sum(x: np.ndarray) -> Optional[float]:
    """Threaded float64 sum of squares of a contiguous float64 buffer.

    Deterministic per length (fixed 4M-element chunks reduced in chunk
    order) but NOT bit-identical to ``np.einsum``'s single sequential
    accumulation — callers gate this on large inputs where the last-ULP
    difference is irrelevant (it feeds only the objective constant).
    Returns None when unavailable or the dtype is not float64.
    """
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x)
    if x.dtype != np.float64:
        return None
    out = np.empty(1, dtype=np.float64)
    lib.sq_sum_f64(
        x.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(x.size),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return float(out[0])


def yty_f64(Y_sketch: np.ndarray) -> float:
    """Frobenius norm-squared of the sketch, f64-accumulated, with the ONE
    policy all solver drivers share: the threaded native reduction takes
    over at atlas scale (>= 2^27 elements, contiguous f64 input) where its
    fixed chunk-ordered association differs from einsum only in the last
    ULP and the value feeds nothing but the objective constant; everything
    else keeps einsum's exact sequential accumulation (bit-stable for the
    f64 trajectory-parity tests). Never copies ``Y_sketch``."""
    if Y_sketch.size >= (1 << 27):
        ys = np.asarray(Y_sketch)
        if ys.dtype == np.float64 and ys.flags.c_contiguous:
            out = sq_sum(ys.ravel())
            if out is not None:
                return out
    return float(np.einsum("ij,ij->", Y_sketch, Y_sketch, dtype=np.float64))


def zero_fill(arr: np.ndarray) -> bool:
    """Zero an array with parallel page-faulting (see C++ ``zero_fill``).

    Returns False (and leaves the array untouched) when the native library
    is unavailable or the array is not C-contiguous — callers fall back to
    single-threaded initialization. (A non-contiguous input must NOT be
    routed through ``ascontiguousarray``: that would zero a temporary copy
    and leave the caller's array untouched while reporting success.)
    """
    lib = _load()
    if lib is None or not arr.flags.c_contiguous:
        return False
    lib.zero_fill(
        arr.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(arr.nbytes),
        ctypes.c_int(_n_threads()),
    )
    return True


def csr_column_subset(Y, gene_idx: np.ndarray):
    """``Y[:, gene_idx]`` for CSR ``Y`` and sorted unique ``gene_idx``.

    Bit-identical to the scipy fancy-column indexing it replaces (kept
    entries stay in row order with unchanged values; the kernel only
    counts, remaps, and copies — no floating-point math) but runs as two
    threaded O(nnz) passes instead of scipy's selection-matrix matmul —
    ~20x at atlas scale. Returns None when the native path is unavailable.
    """
    from scipy import sparse as _sparse

    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    if Y.data.dtype not in (np.float32, np.float64):
        return None  # scipy preserves int dtypes; don't silently promote
    n_rows, n_genes = Y.shape
    indptr, indices, data, tag = _csr_buffers(Y)
    new_col = _subset_map(n_genes, gene_idx)
    row_counts = np.empty(n_rows, dtype=np.int64)
    getattr(lib, f"csr_subset_count_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        new_col.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int(_n_threads()),
        row_counts.ctypes.data_as(ctypes.c_void_p),
    )
    out_indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_counts, out=out_indptr[1:])
    nnz = int(out_indptr[-1])
    out_indices = np.empty(nnz, dtype=np.int32)
    out_data = np.empty(nnz, dtype=data.dtype)
    getattr(lib, f"csr_subset_fill_{tag}")(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        new_col.ctypes.data_as(ctypes.c_void_p),
        out_indptr.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int(_n_threads()),
        out_indices.ctypes.data_as(ctypes.c_void_p),
        out_data.ctypes.data_as(ctypes.c_void_p),
    )
    return _sparse.csr_matrix(
        (out_data, out_indices, out_indptr),
        shape=(n_rows, len(gene_idx)),
        copy=False,
    )


def countsketch_project(
    Y, buckets: np.ndarray, weights: np.ndarray, sketch_dim: int
) -> Optional[np.ndarray]:
    """CountSketch projection of CSR Y: out[r, buckets[g]] += weights[g]*Y[r,g].

    Returns the dense (n_rows, sketch_dim) float64 sketch, or None when the
    native path is unavailable (caller falls back to the scipy matmul).
    """
    lib = _load()
    if lib is None or not _is_csr(Y):
        return None
    n_rows = Y.shape[0]
    indptr, indices, data, tag = _csr_buffers(Y)
    buckets = np.ascontiguousarray(buckets, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    # The kernel indexes buckets/weights by RAW column id with no bounds
    # check (hot loop); catch an undersized operator here instead of
    # corrupting the heap.
    if buckets.shape[0] < Y.shape[1] or weights.shape[0] < Y.shape[1]:
        raise ValueError(
            f"CountSketch operator covers {buckets.shape[0]} genes but Y "
            f"has {Y.shape[1]} columns — for a gene subset use the "
            f"fused_*_project/_xty kernels (subset-indexed buckets)"
        )
    out = np.empty((n_rows, sketch_dim), dtype=np.float64)
    fn = getattr(lib, f"countsketch_project_{tag}")
    fn(
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p),
        buckets.ctypes.data_as(ctypes.c_void_p),
        weights.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n_rows),
        ctypes.c_int64(sketch_dim),
        ctypes.c_int(_n_threads()),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out
