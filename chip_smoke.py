"""Smoke run of flashdeconv_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # where the warm 1M solve's time goes

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version at the main path's shapes, then drives the main
path: a 1M-spot (1000 x 1000 grid, K = 20, sketch 512, kNN-6) prepare and
solve through the fused banded tier, and a 262,144-spot ``fit_transform``
of synthetic Poisson counts. Any failed phase raises, so the exit code is
non-zero; without a card the script fails before it prints any result. The
last two lines are one JSON object per kernel and the result line
``{"ok": true, "device": {...}}``. Needs no JAX and no network.

``--profile`` builds, prepares the 1M problem and runs three warm solves
under ``torch.profiler``, each split by the host clock into the device
solve and the fetch of beta; it prints that split and the profiler's
table, and no result line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# The native host kernels (log-CPM, CountSketch) build into the checkout.
os.environ.setdefault(
    "FLASHDECONV_NATIVE_CACHE",
    str(ROOT / "flashdeconv_tpu_torch" / "ops" / "build" / "native"),
)

SPOTS = 1_000_000
TYPES = 20
SKETCH = 512
FIT_SIDE, FIT_GENES = 512, 2000
SWEEPS = 20
# Kernel against plain: atol / rtol on beta, rtol on the statistics. The
# kernel contracts multiply-adds into FMAs and sums XtX @ beta in its own
# order, so it is held to tolerances, not bitwise.
ATOL, RTOL, STATS_RTOL = 5e-5, 1e-4, 1e-4


def log(*parts) -> None:
    print(*parts, flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def phase_device() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    log(card())
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")


def phase_build() -> None:
    from flashdeconv_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    log(f"[build] {so.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.3f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


def prepare(n_spots: int, n_types: int):
    """The port's prepare on a bench problem: (problem, prepare seconds)."""
    from bench import make_problem
    from flashdeconv_tpu_torch.core.solver import prepare_bcd
    from flashdeconv_tpu_torch.utils import build_knn_graph

    Y, X, coords = make_problem(n_spots, n_types, SKETCH)
    A = build_knn_graph(coords, k=6)
    t0 = time.perf_counter()
    prob = prepare_bcd(Y, X, A, coords=coords, device="cuda")
    torch.cuda.synchronize()
    return prob, time.perf_counter() - t0


def sweep_args(prob, lam=0.1, rho=0.01):
    """Operands of one sweep of ``prob`` from a seeded non-negative carry
    (pads and padded spots zero, as in a solve)."""
    from flashdeconv_tpu_torch.ops import bcd

    rng = np.random.default_rng(prob.n_types)
    beta = np.abs(rng.standard_normal((prob.n_solve, prob.n_types),
                                      dtype=np.float32))
    beta[prob.n_spots:] = 0.0
    carry = bcd.to_fused_carry(torch.from_numpy(beta).cuda(),
                               prob.h_blocks, prob.fused_block)
    inv = bcd.gs_inv_den(prob.XtX_d, prob.nnb_d, lam).contiguous()
    return (carry, prob.Xty_t_d, prob.XtX_d, prob.masks_d, inv, lam,
            rho * prob.mean_diag, prob.offsets, prob.h_blocks,
            prob.fused_block)


def time_sweeps(fn, args) -> float:
    """Warm per-sweep ms over SWEEPS launches, by CUDA events."""
    spare = torch.empty_like(args[0])
    for _ in range(3):
        fn(*args, out=spare)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SWEEPS):
        fn(*args, out=spare)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / SWEEPS


def phase_kernel(prob, label: str) -> dict:
    """One sweep, kernel against plain, then timings in turns."""
    from flashdeconv_tpu_torch.ops import bcd

    args = sweep_args(prob)
    with bcd.full_f32_matmul():
        ref, rd, ra = bcd.fused_banded_sweep_reference(*args)
        got, d, a = bcd.fused_banded_sweep(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(d, rd, atol=0.0, rtol=STATS_RTOL)
        torch.testing.assert_close(a, ra, atol=0.0, rtol=STATS_RTOL)
        pad = prob.h_blocks * prob.fused_block
        if not ((got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()):
            raise AssertionError("pad slabs are not zero")
        if not (got >= 0).all():
            raise AssertionError("negative beta")
        plain, kern = bcd.fused_banded_sweep_reference, bcd.fused_banded_sweep
        ms = {"plain": [], "kernel": []}
        for name, fn in (("plain", plain), ("kernel", kern),
                         ("kernel", kern), ("plain", plain)):
            ms[name].append(time_sweeps(fn, args))
    row = {
        "K": prob.n_types, "U": len(prob.offsets), "n_spots": prob.n_spots,
        "max_abs_err": err, "ms": float(np.mean(ms["kernel"])),
        "plain_ms": float(np.mean(ms["plain"])),
    }
    log(f"[kernel] {label}: K={row['K']} U={row['U']} block="
        f"{prob.fused_block} h={prob.h_blocks} max_abs_err={err:.3e} "
        f"stats ({float(d):.6g}, {float(a):.6g}) vs plain ({float(rd):.6g}, "
        f"{float(ra):.6g}); per sweep kernel {ms['kernel']} ms, plain "
        f"{ms['plain']} ms (plain, kernel, kernel, plain)")
    return row


def phase_solve(prob, prepare_s: float) -> int:
    """Two solves of the 1M problem through the kernel, and one through
    the plain version on the card as the reference."""
    from flashdeconv_tpu_torch.ops import bcd

    if not prob.use_fused_banded:
        raise AssertionError("the 1M problem did not take the fused tier")
    kw = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4)
    sweeps = 0
    for name in ("cold", "warm"):
        before = bcd.fused_banded_sweep.launches
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, info = prob.solve(**kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = bcd.fused_banded_sweep.launches - before
        if launched != info["n_iterations"]:
            raise AssertionError(f"{launched} launches for "
                                 f"{info['n_iterations']} sweeps")
        if not (info["converged"] and np.isfinite(info["final_objective"])
                and np.isfinite(beta).all() and (beta >= 0).all()):
            raise AssertionError(f"bad solve: {info}")
        sweeps += info["n_iterations"]
        log(f"[solve] {name}: {dt:.4f} s, {prob.n_spots / dt:.1f} spots/s, "
            f"{info['n_iterations']} sweeps, objective "
            f"{info['final_objective']:.6g}, rel {info['final_change']:.3e}, "
            f"peak {torch.cuda.max_memory_allocated()} B allocated")
    log(f"[solve] prepare {prepare_s:.3f} s (host precompute + copy)")

    # Reference: the same loop over the plain version, on the card.
    carry = bcd.to_fused_carry(bcd.uniform_beta0(prob.Xty_t_d, prob.n_spots),
                               prob.h_blocks, prob.fused_block)
    lam, rho = bcd.f32(kw["lambda_"]), bcd.f32(kw["rho"] * prob.mean_diag)
    inv = bcd.gs_inv_den(prob.XtX_d, prob.nnb_d, lam)
    with bcd.full_f32_matmul():
        carry, it, _ = bcd.converge_loop(
            lambda c, out: bcd.fused_banded_sweep_reference(
                c, prob.Xty_t_d, prob.XtX_d, prob.masks_d, inv, lam, rho,
                prob.offsets, prob.h_blocks, prob.fused_block, out=out),
            carry, kw["tol"], kw["max_iter"],
        )
    ref = bcd.from_fused_carry(carry, prob.h_blocks,
                               prob.fused_block)[: prob.n_spots]
    if prob._inv_perm_d is not None:
        ref = ref.index_select(0, prob._inv_perm_d)
    diff = float(np.abs(beta - ref.double().cpu().numpy()).max())
    log(f"[solve] plain-version solve: {it} sweeps, max |beta - beta_plain| "
        f"= {diff:.3e}")
    if it != info["n_iterations"] or diff > 1e-4:
        raise AssertionError("kernel solve disagrees with the plain solve")
    return sweeps


def phase_profile(prob, reps: int = 3) -> None:
    """Warm solves of ``prob``, split as ``BCDProblem.solve`` is:
    ``fused_solve`` (ended by a synchronize) and the fetch of beta to host
    f64; beside them the f32 copy of the same beta made contiguous first.
    ``reps`` solves are timed by the host clock with no profiler, then
    ``reps`` more run under ``torch.profiler``, whose table is printed."""
    from torch.profiler import ProfilerActivity, profile

    from flashdeconv_tpu_torch.ops import bcd

    lam, rho = bcd.f32(0.1), bcd.f32(0.01 * prob.mean_diag)

    def timed_solve(label):
        t0 = time.perf_counter()
        beta_d, n_iter = bcd.fused_solve(
            None, prob.Xty_t_d, prob.XtX_d, prob.masks_d, prob.nnb_d,
            prob.YtY, prob._inv_perm_d, lam, rho, 1e-4, 100, prob.offsets,
            prob.h_blocks, prob.fused_block, prob.n_spots,
        )[:2]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        beta_d.to("cpu", torch.float64)
        t2 = time.perf_counter()
        flat = beta_d.contiguous()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        flat.cpu()
        t4 = time.perf_counter()
        log(f"[profile] {label}: {n_iter} sweeps; fused_solve "
            f"{(t1 - t0) * 1e3:.3f} ms; fetch of beta to host f64 "
            f"{(t2 - t1) * 1e3:.3f} ms; f32 copy of beta made contiguous "
            f"{(t4 - t3) * 1e3:.3f} ms")

    timed_solve("warm-up solve")
    for rep in range(reps):
        timed_solve(f"warm solve {rep}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for rep in range(reps):
            timed_solve(f"warm solve {rep} under the profiler")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=25))


def synthetic_counts(side: int, n_genes: int, n_types: int, seed: int = 0,
                     chunk: int = 16384):
    """Seeded Poisson CSR counts on a side x side grid with spatially
    smooth proportions (the recipe of tests/conftest.make_synthetic),
    generated in row chunks. Returns (Y, X, coords, true proportions)."""
    from scipy import sparse

    from flashdeconv_tpu_torch.utils import grid_coords

    rng = np.random.default_rng(seed)
    X = rng.gamma(2.0, 1.0, (n_types, n_genes))
    X *= rng.random((n_types, n_genes)) < 0.3
    m = max(3, n_genes // (n_types * 10))
    marks = rng.choice(n_genes, m * n_types, replace=False)
    for k in range(n_types):
        cols = marks[k * m:(k + 1) * m]
        X[:, cols] = 0.0
        X[k, cols] = rng.gamma(5.0, 2.0, m)
    coords = grid_coords(side=side)
    centers = rng.random((n_types, 2)) * side
    parts, props = [], []
    for s in range(0, coords.shape[0], chunk):
        d2 = ((coords[s:s + chunk, None, :] - centers[None]) ** 2).sum(-1)
        p = np.exp(-d2 / (2 * (0.25 * side) ** 2)
                   + rng.gumbel(0.0, 0.3, d2.shape))
        p /= p.sum(axis=1, keepdims=True)
        mean = p @ X
        mean /= mean.sum(axis=1, keepdims=True)
        depth = rng.gamma(3.0, 1500.0, (len(p), 1))
        parts.append(sparse.csr_matrix(
            rng.poisson(mean * depth).astype(np.float64)))
        props.append(p)
    return (sparse.vstack(parts, format="csr"), X, coords,
            np.concatenate(props))


def phase_fit() -> int:
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.utils import compute_correlation

    t0 = time.perf_counter()
    Y, X, coords, truth = synthetic_counts(FIT_SIDE, FIT_GENES, TYPES)
    log(f"[fit] counts {Y.shape} nnz {Y.nnz} made in "
        f"{time.perf_counter() - t0:.1f} s")
    sweeps = 0
    for name in ("cold", "warm"):  # cold includes first-use host builds
        before = bcd.fused_banded_sweep.launches
        model = FlashDeconv(sketch_dim=SKETCH)
        t0 = time.perf_counter()
        props = model.fit_transform(Y, X, coords)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = bcd.fused_banded_sweep.launches - before
        info = model.info_
        pearson = float(compute_correlation(props, truth))
        log(f"[fit] {name} fit_transform {dt:.3f} s, {info['n_iterations']} "
            f"sweeps, converged {info['converged']}, pearson vs truth "
            f"{pearson:.4f}, lambda {model.lambda_used_:.6g}")
        log("[fit] stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in model.timings_.items()))
        if launched != info["n_iterations"]:
            raise AssertionError(f"{launched} launches for "
                                 f"{info['n_iterations']} sweeps")
        if not np.allclose(props.sum(axis=1), 1.0, atol=1e-9):
            raise AssertionError("proportion rows do not sum to 1")
        if not pearson > 0.9:
            raise AssertionError(f"pearson {pearson} <= 0.9")
        sweeps += info["n_iterations"]
    return sweeps


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the warm 1M solve instead of the "
                             "smoke run")
    args = parser.parse_args()
    phase_device()
    import flashdeconv_tpu_torch  # noqa: F401  (before any host module)
    from flashdeconv_tpu_torch.ops import bcd

    phase_build()
    if args.profile:
        phase_profile(prepare(SPOTS, TYPES)[0])
        return
    rows = []
    for K in (6, 64):
        prob, _ = prepare(256 * 256, K)
        rows.append(phase_kernel(prob, "256x256"))
        del prob
    main_prob, prepare_s = prepare(SPOTS, TYPES)
    main_row = phase_kernel(main_prob, "1000x1000 (main path)")

    # The main path: launches are counted from here on only.
    bcd.fused_banded_sweep.launches = 0
    sweeps = phase_solve(main_prob, prepare_s)
    del main_prob
    sweeps += phase_fit()
    launches = bcd.fused_banded_sweep.launches
    if launches != sweeps or launches == 0:
        raise AssertionError(f"{launches} kernel launches for {sweeps} sweeps")
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")

    for row in rows:
        log(f"[kernel] K={row['K']}: {json.dumps(row)}")
    log(card())
    print(json.dumps({"kernels": [{
        "name": "fused_banded_sweep",
        "route": "cuda",
        "source": "flashdeconv_tpu_torch/ops/csrc/fused_banded_sweep.cu",
        "replaces": "flashdeconv_tpu/ops/bcd.py:650",
        "launches": launches,
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
