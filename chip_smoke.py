"""Smoke run of flashdeconv_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py            # the smoke run
    python3 chip_smoke.py --profile  # where the warm 1M solves' and the
                                     # dense sketch's time goes
    python3 chip_smoke.py --large-k [--against DIR]
                                     # the panel kernels (64 < K <= 384)
                                     # alone
    python3 chip_smoke.py --small-k [--against DIR]
                                     # the sweep kernels at K <= 64 alone
    python3 chip_smoke.py --objective
                                     # the objective kernel alone (K = 20
                                     # and 34)
    python3 chip_smoke.py --neighbor-sum
                                     # the gather tier's neighbour-sum
                                     # kernel alone (the tissue section)
    python3 chip_smoke.py --multicard
                                     # the [multicard] phase alone (two
                                     # cards or more; exits 1 below two)
    python3 chip_smoke.py --multihost-child RANK WORLD PORT DIR BACKEND
                                     # one process of a multi-process job
                                     # (the [multihost] and [multicard]
                                     # phases start them)

Builds the three CUDA kernels from the sources in this checkout (one
``nvcc`` each, in parallel), holds each against its plain PyTorch version
at the main paths' shapes, holds the fused and unfused banded solves
bitwise equal, then drives the three main paths, each with the launch
counts set to 0 just before it and read just after:

1. the fused banded tier: a 1M-spot (1000 x 1000 grid, K = 20, sketch
   512, kNN-6) prepare and solve, and a 262,144-spot ``fit_transform`` of
   synthetic Poisson counts (on the host path, ``device_outputs=False``,
   as every fit before this list's last phase); the grid takes the fused
   tier with no rest tables and launches only the kernel's plain form,
   and the objective kernel once a solve (the plain solve beside
   ``[solve]`` runs the plain objective, within 1e-5 of the kernel's);
   before them the objective kernel is held against the plain path on a
   solved carry of the grid, the objective and each of its five sums,
   and timed in turns with it (``[objective]``); every counted run of a
   fused-tier solve at K <= 56 below counts the objective kernel too (at
   32 < K <= 56 on its ``large_k_launches``); then the same objective
   check and timing on the 1M grid at K = 34 (the Allen whole-mouse-brain
   classes: the objective kernel's KMAX = 40 instance), one sweep of
   kernel #1's spot-panel pass against the plain version and timed in
   turns with it, and two counted solves of it, each one objective launch
   of the large-K form and one spot-panel launch a sweep;
1a. the fit's outputs, on the same 262k counts (a second counted run of
   kernel #1): the host-path fit, and fits with device outputs (the
   default on the card), ``outputs=("dominant",)`` and
   ``fetch_dtype="float16"``, each held to the JAX package's bounds
   against it; ``fit_lambda_path`` at its 5 default lambdas beside a cold
   solve at each lambda on one prepared problem; and the counts stacked
   twice on a 512 x 1024 grid (524,288 spots), whose Xty streams to the
   card in row chunks, bitwise the same fit unstreamed. Before it the
   ``[fetch]`` lines time, on the 1M grid's beta and in turns over 5 warm
   rounds, ``solve()``, ``solve(return_device=True)`` and the fetch of
   beta alone, the former way (f64 cast on the card, pageable copy)
   against ``fetch_to_host`` (pinned, cast on the host), after one cold
   fetch; the same on the 1M irregular problem, and the fetches alone at
   K = 256. After it, a third counted run of kernel #1: the sweep-timing
   protocol of ``utils/timing`` (``fused_sweep_timer_for`` and
   ``fori_difference_windows``: runs of 5 and 30 sweeps queued with no
   host read, each ended by one scalar read, 12 positive windows) on the
   1M grid, its min and median per sweep printed beside the kernel's
   CUDA-event time (``[timing]``); and the 262k grid fit again, untraced
   and with ``FLASHDECONV_TRACE_DIR`` set (``[trace]``), whose
   ``bcd_solve`` Chrome trace must name kernel #1 once a sweep and whose
   beta must be bitwise the untraced fit's;
1b. the fused tier's rest stream (kernel #1's ``ns_rest`` input): the
   1000 x 1000 grid with 1 % of its bins dropped at random (990,042
   spots, K = 20), timed by the sweep-timing protocol (rest update
   included) and prepared and solved, bitwise the unfused banded tier,
   and its objective kernel (the REST instance) held against the plain
   path as on the grid;
   the 1000 x 1000 grid plus 100 symmetric long-range edges, which takes
   the fused tier only after the band-cap rescue, solved and bitwise the
   unfused banded tier on the capped decomposition; and a
   ``fit_transform`` of the 262,144-spot grid's counts with 1 % of the
   bins dropped (259,491 spots). Before them the kernel with ``ns_rest``
   is held against its plain version on the dropped grid and timed in
   turns, beside the rest update, the whole fused+rest sweep and the
   unfused banded sweep on the same operands, and the capped grid's sweep
   (8 bands and the rest stream) beside the plain grid's (16 bands);
2. the gather tier: a 1M-spot irregular problem (uniform random
   coordinates, kNN-6, as Xenium and CosMx sections look) through
   ``prepare_bcd`` and ``solve``, and two ``fit_transform`` runs: a
   Visium-like section of 4,992 spots on a hex lattice and a 100,000-cell
   irregular section (2,000 genes, K = 20). Before them the gather tier's
   neighbour-sum kernel is held bit for bit against the plain loop on a
   seeded carry of the 1M irregular problem and timed in turns with it
   (``[neighbor-sum]``); every counted f32 gather-tier solve here and
   below (the halo plan's, a shard's; the K = 338 gather solves of 7)
   counts its launches, one a sweep and one for the objective, and the
   plain solve beside ``[solve]`` runs the plain loop;
3. the dense-count sketch on the card: a "Xenium 5K-like" section of
   100,000 cells at irregular coordinates with dense counts of 5,001
   genes, all kept (``n_hvg=5001``), K = 20, fitted twice; each fit
   projects Y through the CountSketch kernel once and solves on the
   gather tier;
4. the large-K tier (64 < K <= 256, both kernels' panel form): the 1M grid
   solved at K = 128 and at K = 256 on the fused tier and a 262,144-spot
   grid ``fit_transform`` at K = 96; the 1M irregular problem solved at
   K = 128 on the gather tier. Before them each kernel is held against its
   plain version on those 1M problems at K = 96, 128 and 256 (and at
   K = 65 on the small shapes), and the 1M grid at K = 128 is solved
   through the fused and the unfused banded tier, bitwise equal;
5. the spot-sharded solves, several shards on the one card (each shard its
   own CUDA stream): the 1M grid through ``prepare_sharded_bcd`` on meshes
   of 1, 2 and 4 shards (the banded mesh, kernel #1 per shard): ``solve``,
   unsplit (what ``overlap="auto"`` picks for such shards), then the sweep
   loop alone, unsplit and split by the private loop's ``overlap=True``
   (kernel #1's sub-range form) in turns; and the same at K = 128 on
   2 shards, each bitwise equal to the single-device fused tier with the
   same sweeps; the 1M irregular problem on 2 shards through the halo plan
   (kernel #2 per shard), the gather tier's sweeps and within 1e-5 of its
   beta; and a 262,144-spot ``fit_transform`` on a 2-shard mesh. Before
   them kernel #1's sub-range form is held against its plain version on
   the 1M grid operands at K = 20 and 128 (an interior call and both
   boundary calls, each alone and into one full carry), the three calls'
   recomposition bitwise equal to the whole sweep, and timed against it;
5a. the mesh across processes (``parallel/multihost.py``): the script
   writes the 1M grid's Xty, YtY, X and adjacency and the 262,144-spot
   grid fit's counts to a temporary directory and starts two processes of
   itself (``--multihost-child``) on ``cuda:0``, joined in a Gloo group on
   localhost (NCCL refuses two ranks on one card), each one shard of
   ``global_spot_mesh``: the 1M grid's banded mesh (split: kernel #1's
   sub-range form, the pads through host memory while the interior call
   runs) and halo plan (kernel #2), each a cold ``solve``, and
   ``fit_distributed`` on the counts split at row 130,072; beta, sweeps
   and lambda must be bitwise those of one process's 2-shard mesh (solved
   and fitted here before the job, the same way), and each process's
   launches exactly 3 sub-range calls a sweep and one kernel #2 call and
   one neighbour-sum call a sweep (and one more a halo solve's objective). A sweep's time, there and here, is the difference of the
   medians of 10 runs of 22 and 10 of 2 sweeps, in turns, over 20, with
   its spread over the turns' pairs: of ``solve()`` on the halo plan, and
   of the banded mesh's sweep loop alone, split across processes, and
   unsplit and split (``overlap=True``) in one process; a process that
   fails or outlasts 300 s fails the run;
5b. several cards (``[multicard]``, run when two cards or more are
   visible; on one card the run prints ``[multicard] not run: 1 card
   visible`` and goes on): with ``cuda:0`` current, the 1M grid's fused
   solve and the 1M irregular gather solve on the last card, and the
   100,000 x 5,001 dense sketch there, each bitwise the same on
   ``cuda:0``; the 1M grid's banded mesh on 2 cards (and on 4 where there
   are 4) and at K = 128 on 2, unsplit and split, 240 sweeps (tol 0) of
   the sweep loop, each bitwise one card's mesh of as many shards; the
   1M irregular halo plan on 2 cards and ``FlashDeconv(n_shards=2).fit``
   of the 262k counts, each bitwise one card's 2 shards; and jobs of 2
   (and 4) processes of this script over NCCL, one card a process, each
   bitwise one process's mesh of as many shards on ``cuda:0``, as the
   Gloo job of 5a is. It prints, claiming nothing, a sweep's time (as 5a
   times it) on one card's 1 / 2 / 4 shards, on 2 / 4 cards and in the
   NCCL processes, spots/s and their ratio to one card's, each card's
   peak memory, and each kernel's launches by card, which must add up to
   the wrappers' counts; the launches join the kernels line;
6. the XLA tier in f64 (no kernel takes f64, as no Pallas kernel does in
   the JAX package): the 1M grid at K = 20 prepared in f64 (the unfused
   banded form), a cold ``solve()`` and warm ``solve()`` and
   ``solve(return_device=True)`` timed, with sweeps and peak memory; the
   262,144-spot grid solved in f64 on the card and by the port on the
   CPU, the same sweeps and beta within 1e-12 of max|beta|; and the
   262k-grid fit with ``solver_dtype=np.float64``, Pearson > 0.9;
7. K = 338 (the Allen whole-mouse-brain atlas's subclasses), where the
   tile pass runs its one-block instances (256 < K <= 384): the 1M grid
   in f32 on the fused tier, kernel #1 against plain (its entry
   ``fused_banded_sweep_wide``), then the same three solves, converged,
   each sweep one launch counted on ``.large_k_launches`` and
   ``.wide_launches``; the XLA tier at K = 385 (above the kernels' K) on
   the 262,144-spot grid, the three solves capped at 10 sweeps (the cap
   is printed when it binds); a 4,096-spot irregular problem (the gather
   tier, kernel #2a) on the card and on the CPU, the same sweeps and beta
   within 1e-5 of max|beta|; and a 4,096-cell fit (kernel #2a) with
   ``outputs=("proportions", "dominant")``, whose argmax is fetched as
   int32 and equals the host argmax. Phase 6 runs with every launch
   count at 0 and must leave them there, and checks that its operands lie
   on the card and that its tier runs no sweep kernel; phase 7 must show
   each of its kernel launches and no other;
8. the host arena (``utils/hostmem``), after every other phase, since
   ``mallopt`` changes the allocator for the rest of the process: on a
   freshly prepared 1M grid (K = 20), five warm rounds of a host-path
   ``solve()`` and the same solve split into ``fused_solve`` and
   ``fetch_to_host``, then ``reserve_host_arena(4)`` timed, then five
   rounds again, every beta bitwise the first solve's (``[arena]``; a
   last counted run of kernel #1).

The CountSketch kernel is held against its plain version at 262,144 x
5,001 -> 512 (and at edge shapes), bitwise against itself, against an f64
projection of 1,024 rows, and timed beside ``torch.matmul`` with the dense
operator.

Any failed phase raises, so the exit code is non-zero; without a card the
script fails before it prints any result. The last three lines are one
JSON object per kernel (each CUDA kernel's panel form at 64 < K <= 384 with
an entry of its own, ``*_large_k``, timed at K = 128, kernel #1's
one-block tile pass at 256 < K <= 384, ``fused_banded_sweep_wide``, timed
at K = 338, kernel #1's
spot-panel pass at 32 < K <= 64, ``fused_banded_sweep_spot_panel``, timed
at K = 34, and kernel #1's
sub-range form, ``fused_banded_sweep_sub``, timed as the interior call of
a split 1M x 20 sweep), the card's name and power limit, and the result
line ``{"ok": true, "device": {...}}``; kernel #1 with the rest stream
has the entry ``fused_banded_sweep_rest``, timed on the 1 %-dropped 1M
grid. Needs no JAX and no network.

``--profile`` builds, prepares the 1M grid and the 1M irregular problems
(K = 20) and the 1M grid at K = 256 and, for each, runs warm solves
under ``torch.profiler``, each split by the host clock into the device
solve and the fetch of beta, beside the fetch's parts alone (the
contiguous copy on the card, the pinned allocation, the copy into it,
the host cast into a fresh and into a written array); it prints that
split and the profiler's table. Then it makes the dense fit's
normalised 100,000 x 5,001 counts and runs the fit's ``sketch_data`` on
them, timed by the host clock and once under ``torch.profiler``. It
prints no result line.

``--large-k`` runs the panel kernels alone, a few minutes where the smoke
run takes most of its limit: it builds, prints ptxas's registers, spills
and shared memory of every instance of both panel ``__global__``s and the
blocks an SM holds of each at K = 65-384
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); holds each panel
kernel against its plain version, timed in turns with it, on the 1M grid
(kernel #1) and the 1M irregular problem (kernel #2) at K = 96, 128, 256,
288, 338 and 384 and on the small shapes at K = 65; solves the 1M grid at
K = 128 and 338 through the fused and the unfused banded tier, bitwise
equal; and at K = 338 times the XLA tier's sweep (the banded neighbour
sums and ``ops/bcd.coordinate_descent``, what K = 338 ran before the tile
pass took K > 256) on the same operands beside kernel #1. With
``--against DIR`` it also builds the two sweep kernels from the sources
of the checkout at DIR (into DIR's own build directory) and, on each 1M
problem, times them in turns with this checkout's (theirs, ours, ours,
theirs) on the same operands, printing whether the two give the same bits.
It prints no result line.

``--small-k`` does the same for K <= 64, where both sweep kernels run the
register pass of ``gs_pass.cuh`` up to K = 32 and, from K = 33, kernel #1
the spot-panel pass and kernel #2 the tile pass (TM = 2) of
``gs_pass_panel.cuh``: ptxas's registers and spills of every register
``__global__``, of the spot-panel ones and of the panel ones of TM <= 2,
and the blocks an SM holds at K = 1-64 (with each pass's shared memory);
then at 1M spots and K = 6, 20, 32, 34, 48 and 64 kernel #1 on the grid (the
whole sweep, and the sub-range form's interior call), kernel #1 with the
rest stream on the 1 %-dropped grid and kernel #2 on the irregular
problem, each against its plain version and timed in turns with it, with
``--against DIR`` each of those four forms against DIR's build, bitwise
and in turns; and the 1M grid at K = 20 solved through the fused and the
unfused banded tier, bitwise equal; at K = 34, 48 and 64 the grid is also
solved twice (``[solve]``, against the plain solve), counted: one
spot-panel launch a sweep, one objective launch of the large-K form a
solve at K = 34 and 48, none at K = 64 (above the objective kernel's K).
It prints no result line.

``--objective`` builds, prepares the 1M grid (K = 20), solves it and, on
the solved carry, holds the fused tier's objective kernel (one launch a
call) against the plain path and against the plain path in f64, the
objective and each of its five sums, and times in turns by CUDA events
the launch alone against the plain path's device work, and the whole
objective call (the read of the result included) against the plain
path's (``[objective]``, as in the smoke run); then the same on the
grid with 1 % of its bins dropped, with the rest stream, and on the 1M
grid at K = 34 (the kernel's KMAX = 40 instance). It prints no result
line.

``--neighbor-sum`` builds and prepares the benchmark's tissue section
(``portbench/configs/vhd8um_tissue_k20.json``: 417,768 bins, kNN-6,
D = 10 slots, the gather tier) at K = 20 and 96 and, on a seeded carry,
holds the gather tier's neighbour-sum kernel (one launch, from the
unpadded carry) bitwise against the plain loop over the padded copy, and
times the two in turns by CUDA events; then solves the section at
K = 20, counted, through the kernel's route and through the plain loop
(the parent's neighbour sums) in turns: the same beta bits and sweeps,
one launch a sweep and one for the objective, and the wall time of each
solve (``[neighbor-sum]``). It prints no result line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SPOTS = 1_000_000
TYPES = 20
LARGE_TYPES = (96, 128, 256)        # the large-K kernel rows at 1M spots
WIDE_TYPES = (288, 338, 384)        # --large-k's rows past K = 256
SMALL_TYPES = (6, 20, 32, 34, 48, 64)  # the K <= 64 rows at 1M spots
WIDE_OBJECTIVE_TYPES = 34           # Allen whole-mouse-brain classes
FIT_LARGE_TYPES = 96
ATLAS_TYPES = 338                   # Allen whole-mouse-brain subclasses
XLA_CAP = 10                        # sweeps timed of the 1M x 338 solve
SKETCH = 512
FIT_SIDE, FIT_GENES = 512, 2000
DENSE_GENES = 5001                  # a 10x Xenium Prime 5K panel
CS_ROWS = 262_144                   # the CountSketch kernel's main shape
VISIUM_COLS, VISIUM_ROWS = 78, 64   # 4,992 spots, as a Visium capture area
CELLS = 100_000
SWEEPS = 20
# Kernel against plain: atol / rtol on beta, rtol on the statistics. The
# kernels contract multiply-adds into FMAs and sum XtX @ beta in their own
# order, so they are held to tolerances, not bitwise.
ATOL, RTOL, STATS_RTOL = 5e-5, 1e-4, 1e-4
# CountSketch against its plain version (and f64): 2e-5 * max(max|ref|, 1),
# the JAX package's own bound (benchmarks/hw_parity.py, check 4).
CS_RTOL = 2e-5
# The card's peaks (NVIDIA's H100 SXM data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SOLVE = dict(lambda_=0.1, rho=0.01, max_iter=100, tol=1e-4)
# The objective kernel against the plain path on a solved 1M carry: the
# objective (the JAX parity tests' bound; 1.0e-6 measured on the grid,
# 1.7e-6 on the dropped grid) and each of its five sums (at most 2.9e-7
# measured, the plain path's own gap from f64 on quad).
OBJECTIVE_RTOL, OBJECTIVE_SUM_RTOL = 1e-5, 2e-6
MESH_SHARDS = (1, 2, 4)             # shards of the 1M grid on the one card
PROCESSES = 2                       # the [multihost] job's processes
MULTICARD_SWEEPS = 240              # sweeps of each [multicard] mesh check
SWEEP_RUNS = (2, 22, 22, 2) * 5     # sweeps of the timed runs, in turns
MULTIHOST_TIMEOUT = 300             # seconds the parent waits for the job
DROP = 0.01                         # share of bins dropped from a grid
ARENA_GB = 4                        # the [arena] phase's reserved heap
ARENA_ROUNDS = 5                    # warm solves timed before and after
RESCUE_EDGES = 100                  # long-range edges of the rescue case
# The single-device solves' (beta on the host, sweeps) by label, which the
# sharded solves of the same problems are held against.
REFERENCE = {}
# One process's P-shard references of a job of P processes, by P.
JOB_REFS = {}


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


def phase_build(spills_fatal: bool = True) -> None:
    """Builds and loads the kernels and prints ptxas's report; a spill
    fails the run unless ``spills_fatal`` is False (the ``--large-k``
    design runs, which report every panel instance's spills)."""
    from flashdeconv_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    for name in libs:
        _build.load(name)
    log(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    if len(libs) != 3:
        raise AssertionError(f"expected 3 kernels, built {sorted(libs)}")
    for name, so in libs.items():
        log(f"[build] {so.relative_to(ROOT)}")
        for line in so.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {name}: {line.strip()}")
            spills = re.findall(r"(\d+) bytes spill", line)
            if spills_fatal and any(int(s) for s in spills):
                raise AssertionError(f"{name} spills registers: {line}")


# -- problems -----------------------------------------------------------------

def tissue_problem(n_types: int):
    """The benchmark's tissue section (its layout and kNN graph, from
    ``portbench/configs/vhd8um_tissue_k20.json``) with
    ``bench.make_problem``'s numbers over its coordinates at ``n_types``,
    prepared on the card: (problem, seconds)."""
    from portbench.inputs import knn_graph as section_graph
    from portbench.inputs import layout_coords

    cfg = json.loads((ROOT / "portbench" / "configs"
                      / "vhd8um_tissue_k20.json").read_text())
    coords = layout_coords(cfg["layout"])
    return prepare_on(coords, section_graph(coords, cfg["k_neighbors"]),
                      n_types)


def make_problem(n_spots: int, n_types: int, d: int, seed: int = 0,
                 coords=None):
    """Synthetic sketch-space problem with spatially smooth ground truth.

    With ``coords`` None, the same numbers from the same seed as
    ``bench.make_problem`` (a grid of n_spots); otherwise the same recipe
    over the given (n_spots, 2) coordinates."""
    from flashdeconv_tpu_torch.utils.graph import grid_coords

    rng = np.random.default_rng(seed)  # PCG64: fast f32 draws at 1M x 512
    side = int(np.ceil(np.sqrt(n_spots)))
    if coords is None:
        coords = grid_coords(n_spots)

    X_sketch = rng.standard_normal((n_types, d), dtype=np.float32)

    # Smooth ground-truth abundances: soft assignment to K spatial centers.
    centers = rng.random((n_types, 2)) * side
    beta_true = np.empty((n_spots, n_types), dtype=np.float32)
    scale = 2.0 * (0.25 * side) ** 2
    for k in range(n_types):  # per-type pass keeps peak memory O(N)
        d2 = ((coords - centers[k]) ** 2).sum(axis=1)
        beta_true[:, k] = np.exp(-d2 / scale)
    beta_true /= beta_true.sum(axis=1, keepdims=True)

    Y_sketch = beta_true @ X_sketch
    # Chunked noise add: the same stream as one call, a smaller temporary.
    step = 1 << 17
    for s in range(0, n_spots, step):
        e = min(n_spots, s + step)
        noise = rng.standard_normal((e - s, d), dtype=np.float32)
        noise *= 0.05
        Y_sketch[s:e] += noise
    return Y_sketch, X_sketch, coords


def irregular_coords(n_spots: int, seed: int = 1) -> np.ndarray:
    """Uniform random coordinates at one spot per unit area."""
    side = np.sqrt(n_spots)
    return np.random.default_rng(seed).random((n_spots, 2)) * side


def hex_coords(cols: int, rows: int) -> np.ndarray:
    """A hexagonal lattice (odd rows shifted half a spot), as Visium's."""
    r, c = np.divmod(np.arange(cols * rows), cols)
    return np.column_stack([c + 0.5 * (r % 2), r * np.sqrt(3) / 2])


@functools.lru_cache(maxsize=2)
def knn_graph(n_spots: int, irregular: bool):
    """(coords, kNN-6 adjacency) of the grid or the irregular section,
    built once per shape: every K of one shape shares them (read only)."""
    from flashdeconv_tpu_torch.utils import build_knn_graph, grid_coords

    coords = irregular_coords(n_spots) if irregular else grid_coords(n_spots)
    return coords, build_knn_graph(coords, k=6)


def prepare(n_spots: int, n_types: int, irregular: bool = False):
    """The port's prepare on a synthetic problem: (problem, seconds)."""
    coords, A = knn_graph(n_spots, irregular)
    return prepare_on(coords, A, n_types, grid=not irregular)


def drop_mask(n: int, frac: float = DROP, seed: int = 0) -> np.ndarray:
    """Bins kept when a share ``frac`` of ``n`` is dropped at random (a
    seeded ``RandomState``): a section whose empty or low-count bins were
    filtered out before deconvolution."""
    return np.random.RandomState(seed).rand(n) >= frac


def with_rescue_edges(A):
    """``A`` plus ``RESCUE_EDGES`` symmetric long-range edges from spots of
    its first half, 60,000-120,000 spots away (``RandomState(1)``, as the
    JAX package's tests/test_fused_banded.py builds its rescue case)."""
    from scipy import sparse

    n = A.shape[0]
    rng = np.random.RandomState(1)
    src = rng.choice(n // 2, RESCUE_EDGES, replace=False)
    dst = src + rng.randint(60_000, 120_000, size=RESCUE_EDGES)
    extra = sparse.coo_matrix(
        (np.ones(2 * RESCUE_EDGES), (np.r_[src, dst], np.r_[dst, src])),
        shape=(n, n))
    return ((A + extra.tocsr()) > 0).astype(np.float64)


def prepare_on(coords, A, n_types: int, grid: bool = False,
               dtype=np.float32):
    """The port's prepare of a synthetic problem over ``coords`` and graph
    ``A`` (with ``grid``, the numbers of ``bench.make_problem`` for a full
    grid) in ``dtype``: (problem, seconds)."""
    from flashdeconv_tpu_torch.core.solver import prepare_bcd

    Y, X, _ = make_problem(coords.shape[0], n_types, SKETCH,
                           coords=None if grid else coords)
    t0 = time.perf_counter()
    prob = prepare_bcd(Y, X, A, coords=coords, dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    return prob, time.perf_counter() - t0


def synthetic_counts(coords, extent: float, n_genes: int, n_types: int,
                     seed: int = 0, chunk: int = 16384, dense: bool = False,
                     width: float = 0.25, depth: float = 1500.0):
    """Seeded Poisson counts with spatially smooth proportions over
    ``coords`` (the recipe of tests/conftest.make_synthetic), generated in
    row chunks: CSR, or with ``dense`` one f64 array. ``width`` is each
    type's spatial domain as a share of ``extent``; ``depth`` the scale of
    the gamma(3) counts per spot. Returns (Y, X, true proportions)."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    Y = np.empty((coords.shape[0], n_genes)) if dense else None
    X = rng.gamma(2.0, 1.0, (n_types, n_genes))
    X *= rng.random((n_types, n_genes)) < 0.3
    m = max(3, n_genes // (n_types * 10))
    marks = rng.choice(n_genes, m * n_types, replace=False)
    for k in range(n_types):
        cols = marks[k * m:(k + 1) * m]
        X[:, cols] = 0.0
        X[k, cols] = rng.gamma(5.0, 2.0, m)
    centers = rng.random((n_types, 2)) * extent
    parts, props = [], []
    for s in range(0, coords.shape[0], chunk):
        d2 = ((coords[s:s + chunk, None, :] - centers[None]) ** 2).sum(-1)
        p = np.exp(-d2 / (2 * (width * extent) ** 2)
                   + rng.gumbel(0.0, 0.3, d2.shape))
        p /= p.sum(axis=1, keepdims=True)
        mean = p @ X
        mean /= mean.sum(axis=1, keepdims=True)
        counts = rng.poisson(mean * rng.gamma(3.0, depth, (len(p), 1)))
        if dense:
            Y[s:s + chunk] = counts
        else:
            parts.append(sparse.csr_matrix(counts.astype(np.float64)))
        props.append(p)
    if not dense:
        Y = sparse.vstack(parts, format="csr")
    return Y, X, np.concatenate(props)


# -- kernels against their plain versions ---------------------------------------

def event_ms(fn, reps: int = SWEEPS) -> float:
    """Warm per-call ms of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_sweeps(fn, args, out) -> float:
    """Warm per-launch ms over SWEEPS launches, by CUDA events."""
    return event_ms(lambda: fn(*args, out=out))


def in_turns(plain, kern, args, out) -> dict:
    """CUDA-event times in turns plain, kernel, kernel, plain."""
    ms = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                     ("plain", plain)):
        ms[name].append(time_sweeps(fn, args, out))
    return ms


def seeded_beta(prob) -> torch.Tensor:
    """A seeded non-negative (n_solve, K) beta, padded spots zero."""
    rng = np.random.default_rng(prob.n_types)
    beta = np.abs(rng.standard_normal((prob.n_solve, prob.n_types),
                                      dtype=np.float32))
    beta[prob.n_spots:] = 0.0
    return torch.from_numpy(beta).cuda()


def bound_ms(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    if by_bytes >= by_ops:
        return by_bytes * 1e3, "bytes"
    return by_ops * 1e3, "operations"


def gs_ops(K: int, n: int) -> float:
    """f32 operations of the Gauss-Seidel pass over n spots: the XtX @ beta
    product (2K^2), the rank-1 refreshes (K(K-1)) and ~8 per coordinate."""
    return n * (2.0 * K * K + K * (K - 1) + 8.0 * K)


def check_close(got, ref, d, rd, a, ra, label):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(d, rd, atol=0.0, rtol=STATS_RTOL)
    torch.testing.assert_close(a, ra, atol=0.0, rtol=STATS_RTOL)
    if not (got >= 0).all():
        raise AssertionError(f"{label}: negative beta")
    return float((got - ref).abs().max())


def phase_fused_kernel(prob, label: str) -> dict:
    """One fused sweep, kernel against plain, then timings in turns."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    carry = bcd.to_fused_carry(seeded_beta(prob), t.h, t.block)
    inv = bcd.gs_inv_den(t.XtX, t.nnb, lam).contiguous()
    args = (carry, t.Xty_t, t.XtX, t.masks, inv, lam, rho, t.offsets, t.h,
            t.block)
    with bcd.full_f32_matmul():
        ref, rd, ra = bcd.fused_banded_sweep_reference(*args)
        got, d, a = bcd.fused_banded_sweep(*args)
        err = check_close(got, ref, d, rd, a, ra, label)
        pad = t.h * t.block
        if not ((got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()):
            raise AssertionError("pad slabs are not zero")
        ms = in_turns(bcd.fused_banded_sweep_reference, bcd.fused_banded_sweep,
                      args, torch.empty_like(carry))
    K, n_ext = carry.shape
    n_bytes = (4.0 * K * (2 * n_ext + 2 * prob.n_solve) + t.masks.numel()
               + 4.0 * K * K)
    bound, by = bound_ms(n_bytes, gs_ops(K, prob.n_solve)
                         + K * float(t.masks.sum()))
    row = {"K": K, "U": len(t.offsets), "n_spots": prob.n_spots,
           "max_abs_err": err, "ms": float(np.mean(ms["kernel"])),
           "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
           "bound_by": by}
    log(f"[kernel] fused_banded_sweep {label}: K={K} U={row['U']} block="
        f"{t.block} h={t.h} max_abs_err={err:.3e} stats ({float(d):.6g}, "
        f"{float(a):.6g}) vs plain ({float(rd):.6g}, {float(ra):.6g}); per "
        f"sweep kernel {ms['kernel']} ms, plain {ms['plain']} ms (plain, "
        f"kernel, kernel, plain); bound {bound:.4f} ms ({by})")
    return row


def phase_cd_kernel(prob, label: str) -> dict:
    """One coordinate-descent pass on the gather tier's neighbour sums of a
    seeded beta, kernel against plain, then timings in turns."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    beta_t = seeded_beta(prob).T.contiguous()
    ns = bcd.gather_neighbor_sums(beta_t, t.nbr, t.overflow)
    inv = bcd.gs_inv_den(t.XtX, t.nnb, lam).contiguous()
    args = (beta_t, t.Xty_t, t.XtX, ns, inv, lam, rho)
    with bcd.full_f32_matmul():
        ref, rd, ra = bcd.coordinate_descent_block_reference(*args)
        got, d, a = bcd.coordinate_descent_block(*args)
        err = check_close(got, ref, d, rd, a, ra, label)
        ms = in_turns(bcd.coordinate_descent_block_reference,
                      bcd.coordinate_descent_block, args,
                      torch.empty_like(beta_t))
    K, n = beta_t.shape
    bound, by = bound_ms(4.0 * K * 5 * n + 4.0 * K * K, gs_ops(K, n))
    row = {"K": K, "D": int(t.nbr.shape[0]), "n_spots": n,
           "max_abs_err": err, "ms": float(np.mean(ms["kernel"])),
           "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
           "bound_by": by}
    log(f"[kernel] coordinate_descent_block {label}: K={K} n={n} "
        f"max_abs_err={err:.3e} stats ({float(d):.6g}, {float(a):.6g}) vs "
        f"plain ({float(rd):.6g}, {float(ra):.6g}); per pass kernel "
        f"{ms['kernel']} ms, plain {ms['plain']} ms (plain, kernel, kernel, "
        f"plain); bound {bound:.4f} ms ({by})")
    return row


def cs_operands(n_rows: int, n_genes: int, d: int, seed: int = 0):
    """Non-negative f32 rows drawn on the card from a seeded generator and
    a leverage-weighted CountSketch operator: (Y, buckets, weights, op)."""
    from flashdeconv_tpu_torch.core.sketching import make_countsketch_op

    gen = torch.Generator(device="cuda").manual_seed(seed)
    Y = torch.rand((n_rows, n_genes), generator=gen, device="cuda")
    Y *= 6.0
    lev = np.random.default_rng(seed).random(n_genes)
    op = make_countsketch_op(n_genes, d, lev, random_state=0)
    buckets = torch.from_numpy(op.buckets).cuda()
    weights = torch.from_numpy(op.weights.astype(np.float32)).cuda()
    return Y, buckets, weights, op


def cs_check(got, ref, label: str) -> float:
    """max |got - ref|, which must be within CS_RTOL * max(max|ref|, 1)."""
    torch.cuda.synchronize()
    err = float((got.double() - ref.double()).abs().max())
    tol = CS_RTOL * max(float(ref.abs().max()), 1.0)
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"countsketch {label}: max |err| {err} > {tol}")
    return err


def phase_countsketch_kernel() -> dict:
    """Kernel #3 against its plain version at the main path's shape and at
    edge shapes, bitwise against itself, against f64 on 1,024 rows, then
    timed in turns with its plain version and ``torch.matmul``."""
    from flashdeconv_tpu_torch.ops import _build, bcd
    from flashdeconv_tpu_torch.ops import countsketch as cs

    for n, g, d in ((1024, 4097, 512), (1024, 4097, 100), (1024, 4097, 2048),
                    (1029, DENSE_GENES, 100)):
        Y, b, w, _ = cs_operands(n, g, d, seed=n + d)
        err = cs_check(cs.countsketch_project_kernel(Y, b, w, d),
                       cs.countsketch_project_reference(Y, b, w, d),
                       f"{n}x{g}->{d}")
        log(f"[kernel] countsketch_project {n}x{g}->{d}: max_abs_err "
            f"{err:.3e}")
        del Y

    n, g, d = CS_ROWS, DENSE_GENES, SKETCH
    Y, b, w, op = cs_operands(n, g, d)
    ref = cs.countsketch_project_reference(Y, b, w, d)
    got = cs.countsketch_project_kernel(Y, b, w, d)
    err = cs_check(got, ref, "main shape")
    again = cs.countsketch_project_kernel(Y, b, w, d)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("two countsketch kernel calls differ")
    omega64 = torch.from_numpy(op.to_dense(np.float64)).cuda()
    err64 = cs_check(got[:1024], Y[:1024].double() @ omega64, "f64 rows")
    del ref, again, omega64

    omega = torch.from_numpy(op.to_dense(np.float32)).cuda()
    fns = {
        "plain": cs.countsketch_project_reference,
        "kernel": cs.countsketch_project_kernel,
        "library": lambda Y, b, w, d, out: torch.matmul(Y, omega, out=out),
    }
    ms = {name: [] for name in fns}
    tile = _build.load("countsketch_project").fdt_countsketch_gene_tile()
    plan_ms = time_sweeps(lambda *a, out: cs.gene_plan(*a), (b, w, d, tile),
                          None)
    with bcd.full_f32_matmul():
        lib_err = cs_check(fns["library"](Y, b, w, d, torch.empty_like(got)),
                           got, "torch.matmul")
        for name in ("plain", "kernel", "library", "library", "kernel",
                     "plain"):
            ms[name].append(time_sweeps(fns[name], (Y, b, w, d), got))
    n_bytes = 4.0 * (n * g + n * d) + 8.0 * g
    bound, by = bound_ms(n_bytes, 2.0 * n * g)
    row = {"max_abs_err": err, "ms": float(np.mean(ms["kernel"])),
           "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
           "bound_by": by, "library_ms": float(np.mean(ms["library"]))}
    log(f"[kernel] countsketch_project {n}x{g}->{d} (main path): "
        f"max_abs_err {err:.3e} vs plain, {err64:.3e} vs f64 on 1,024 rows, "
        f"{lib_err:.3e} torch.matmul vs kernel; two calls bitwise equal; "
        f"per call kernel {ms['kernel']} ms, plain {ms['plain']} ms, "
        f"torch.matmul {ms['library']} ms (plain, kernel, library, library, "
        f"kernel, plain); the kernel's time includes its wrapper's gene "
        f"sort, alone {plan_ms:.4f} ms; bound {bound:.4f} ms ({by}, "
        f"{n_bytes / 1e9:.3f} GB)")
    return row


def phase_fused_vs_unfused(prob) -> None:
    """A fused-tier problem's operands solved through the fused tier (with
    its rest stream, if it has one) and through the unfused banded tier on
    the same decomposition: the same sweeps and beta, bit for bit."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    banded = t.unfused()
    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * prob.mean_diag)
    out = {}
    for name, tier in (("fused", t), ("unfused", banded)):
        beta, it, rel, conv, _ = bcd.fused_solve(
            None, tier, None, lam, rho, SOLVE["tol"], SOLVE["max_iter"],
            prob.n_spots)
        torch.cuda.synchronize()
        out[name] = (beta, it, conv)
    same = torch.equal(out["fused"][0], out["unfused"][0])
    log(f"[bitwise] fused {out['fused'][1]} sweeps, unfused banded "
        f"{out['unfused'][1]} sweeps, beta bitwise equal: {same}")
    if not (same and out["fused"][1] == out["unfused"][1]
            and out["fused"][2]):
        raise AssertionError("fused and unfused banded solves differ")


def f32_bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of an f32 tensor (-0.0 is not +0.0 here)."""
    return t.contiguous().view(torch.int32)


def phase_neighbor_sum(prob, label: str) -> dict:
    """The gather tier's neighbour sums of a seeded carry: the kernel (one
    launch, from the unpadded carry; and from the padded copy, whose zero
    column it reads) bitwise against the plain loop, then CUDA-event times
    in turns (plain, kernel, kernel, plain). Returns the kernels line's
    row."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    if type(t).__name__ != "GatherTier" or t.overflow is not None:
        raise AssertionError(f"{label}: not the gather tier without hubs")
    beta_t = seeded_beta(prob).T.contiguous()
    K, n = beta_t.shape
    D = int(t.nbr.shape[0])

    def plain():
        return bcd.neighbor_sum_reference(beta_t, t.nbr)

    def kern():
        return bcd.neighbor_sum(beta_t, t.nbr)

    before = bcd.neighbor_sum.launches
    ref, got = plain(), kern()
    padded = bcd.neighbor_sum(bcd.with_sentinel(beta_t), t.nbr)
    torch.cuda.synchronize()
    if bcd.neighbor_sum.launches - before != 2:
        raise AssertionError(f"{label}: expected 2 launches")
    for name, out in (("unpadded", got), ("padded", padded)):
        if not torch.equal(f32_bits(out), f32_bits(ref)):
            raise AssertionError(f"{label}: the kernel's sums from the "
                                 f"{name} carry are not the plain loop's")
    ms = {"plain": [], "kernel": []}
    for name, fn in (("plain", plain), ("kernel", kern), ("kernel", kern),
                     ("plain", plain)):
        ms[name].append(event_ms(fn))
    bound, by = bound_ms(4.0 * (D * n + 2 * K * n), float(K * (D - 1) * n))
    log(f"[neighbor-sum] {label}: K={K} n={n} D={D}, bitwise the plain "
        f"loop (unpadded and padded carry); per call kernel {ms['kernel']} "
        f"ms, plain {ms['plain']} ms (plain, kernel, kernel, plain); bound "
        f"{bound:.4f} ms ({by}), kernel at "
        f"{100.0 * bound / np.mean(ms['kernel']):.1f} % of it")
    return {"K": K, "max_abs_err": 0.0, "ms": float(np.mean(ms["kernel"])),
            "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
            "bound_by": by}


def phase_gather_route_solves(prob, label: str, rounds: int = 3,
                              solves: int = 10) -> None:
    """Solves of ``prob`` through the neighbour-sum kernel and through the
    plain loop, counted: the same beta bits and sweeps, one kernel launch
    a sweep and one for the objective, none on the plain route; then
    ``rounds`` x (plain, kernel, kernel, plain) of ``solves`` warm solves
    each, the wall time a solve (synchronised)."""
    from unittest import mock

    from flashdeconv_tpu_torch.ops import bcd

    def run(kernel: bool):
        with mock.patch.object(bcd, "neighbor_sum_kernel_takes",
                               bcd.neighbor_sum_kernel_takes if kernel
                               else (lambda t: False)):
            before = bcd.neighbor_sum.launches
            beta, info = prob.solve(**SOLVE, return_device=True)
            torch.cuda.synchronize()
            return beta, info, bcd.neighbor_sum.launches - before

    beta_k, info_k, n_k = run(True)
    beta_p, info_p, n_p = run(False)
    sweeps = info_k["n_iterations"]
    if (n_k, n_p) != (sweeps + 1, 0):
        raise AssertionError(f"{label}: launches {n_k} / {n_p}, expected "
                             f"{sweeps + 1} / 0")
    if info_p["n_iterations"] != sweeps or not torch.equal(
            f32_bits(beta_k), f32_bits(beta_p)):
        raise AssertionError(f"{label}: the kernel's solve is not the plain "
                             "loop's bit for bit")
    ms = {"plain": [], "kernel": []}
    for _ in range(rounds):
        for name in ("plain", "kernel", "kernel", "plain"):
            t0 = time.perf_counter()
            for _ in range(solves):
                run(name == "kernel")
            ms[name].append(1e3 * (time.perf_counter() - t0) / solves)
    log(f"[neighbor-sum] {label} solves: {sweeps} sweeps, {n_k} launches a "
        f"solve, beta bitwise the plain loop's; ms a solve kernel "
        f"{[round(v, 4) for v in ms['kernel']]}, plain "
        f"{[round(v, 4) for v in ms['plain']]} (plain, kernel, kernel, plain "
        f"x {rounds}); medians {np.median(ms['kernel']):.4f} / "
        f"{np.median(ms['plain']):.4f} ms")


def phase_objective(prob, label: str) -> dict:
    """The fused tier's objective on the carry of a solve of ``prob``
    (lambda 0.1, rho 0.01 x mean diag; with the rest stream where the tier
    has rest tables): the objective kernel's route (one launch) against
    the plain path and against the plain path in f64 on the same carry,
    the objective within ``OBJECTIVE_RTOL`` of the plain path's and each
    of its five sums (cross, degree, adjacency, L1, quad) within
    ``OBJECTIVE_SUM_RTOL`` of the plain path's; then CUDA-event times in
    turns (plain, kernel, kernel, plain) of the launch alone against the
    plain path's device work, and of the whole objective call, the read
    of the result included. Returns the kernels line's row."""
    from flashdeconv_tpu_torch.ops import _build, bcd

    t = prob.tier
    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * prob.mean_diag)
    beta, it = bcd.fused_solve(None, t, None, lam, rho, SOLVE["tol"],
                               SOLVE["max_iter"], prob.n_spots)[:2]
    full = beta.new_zeros((prob.n_solve, prob.n_types))
    full[:prob.n_spots] = beta
    carry = t.carry(full)
    rest = dict(rest_touched=t.rest_touched, rest_slot_cols=t.rest_slot_cols)
    args = (carry, t.Xty_t, t.XtX, t.YtY, t.offsets, t.masks, lam, rho, t.h,
            t.block)
    nnb = t.nnb.reshape(-1)
    nsr = None if t.rest_touched is None else bcd.rest_ns_update(
        torch.zeros_like(t.Xty_t), carry, t.rest_touched, t.rest_slot_cols)

    def kernel_call():
        return float(bcd.objective_terms_banded_fused(*args, nnb=t.nnb,
                                                      **rest))

    def plain_device():
        return bcd.objective_terms_banded_fused_reference(*args, nnb=t.nnb,
                                                          **rest)

    def plain_sums(dtype):
        return bcd.fused_banded_objective_sums_reference(
            carry.to(dtype), t.Xty_t.to(dtype), t.XtX.to(dtype), t.offsets,
            t.masks, t.h, t.block, t.nnb.to(dtype), **rest).cpu().double()

    def objective_launches():
        return (bcd.fused_banded_objective.launches
                + bcd.fused_banded_objective.large_k_launches)

    with bcd.full_f32_matmul():
        before = objective_launches()
        got = kernel_call()
        sums = bcd.fused_banded_objective_sums(
            carry, t.Xty_t, t.XtX, t.masks, nnb, t.offsets, t.h, t.block,
            nsr).double()
        if objective_launches() != before + 2:
            raise AssertionError(f"{label}: the objective kernel did not "
                                 "launch once a call")
        plain = float(plain_device())
        f64 = float(bcd.objective_terms_banded_fused_reference(
            carry.double(), t.Xty_t.double(), t.XtX.double(), t.YtY,
            t.offsets, t.masks, lam, rho, t.h, t.block,
            nnb=t.nnb.double(), **rest))
        plain_s, f64_s = plain_sums(torch.float32), plain_sums(torch.float64)
        lib = _build.load("fused_banded_sweep")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            bcd.fused_objective_launch(lib, stream, carry, t.Xty_t, t.XtX,
                                       t.masks, nnb, t.offsets, t.h, t.block,
                                       nsr)

        turns = {"plain device": [], "kernel launch": [], "plain call": [],
                 "kernel call": []}
        for a, b in ((plain_device, "plain device"), (launch, "kernel launch"),
                     (launch, "kernel launch"), (plain_device, "plain device"),
                     (lambda: float(plain_device()), "plain call"),
                     (kernel_call, "kernel call"), (kernel_call, "kernel call"),
                     (lambda: float(plain_device()), "plain call")):
            turns[b].append(event_ms(a))
    diff = {"kernel_vs_plain": abs(got - plain) / abs(plain),
            "kernel_vs_f64": abs(got - f64) / abs(f64),
            "plain_vs_f64": abs(plain - f64) / abs(f64)}
    names = ("cross", "deg", "adj", "l1", "quad")
    sum_diff = {
        vs: dict(zip(names, ((a - b).abs() / b.abs()).tolist()))
        for vs, a, b in (("kernel_vs_plain", sums, plain_s),
                         ("kernel_vs_f64", sums, f64_s),
                         ("plain_vs_f64", plain_s, f64_s))}
    log(f"[objective] {label}: sums {dict(zip(names, sums.tolist()))}; "
        f"relative differences by sum {sum_diff}")
    if diff["kernel_vs_plain"] > OBJECTIVE_RTOL:
        raise AssertionError(f"{label}: objective {got} against the plain "
                             f"path's {plain}")
    if max(sum_diff["kernel_vs_plain"].values()) > OBJECTIVE_SUM_RTOL:
        raise AssertionError(f"{label}: the kernel's sums "
                             f"{sum_diff['kernel_vs_plain']} off the plain "
                             "path's")
    K, n = t.Xty_t.shape
    n_bytes = (4.0 * K * n * (2 + (nsr is not None)) + t.masks.numel()
               + 4.0 * n + 4.0 * K * K)
    bound, by = bound_ms(n_bytes, n * (2.0 * K * K + 8.0 * K))
    row = {"K": K, "U": len(t.offsets), "n_spots": prob.n_spots,
           "sweeps": it, "objective": got, "plain": plain, "f64": f64,
           "rel_diff": diff, "sum_rel_diff": sum_diff,
           "max_abs_err": abs(got - plain),
           "ms": float(np.mean(turns["kernel launch"])),
           "plain_ms": float(np.mean(turns["plain device"])),
           "call_ms": float(np.mean(turns["kernel call"])),
           "plain_call_ms": float(np.mean(turns["plain call"])),
           "bound_ms": bound, "bound_by": by, "bytes": n_bytes}
    log(f"[objective] {label}: K={K} U={row['U']} rest "
        f"{nsr is not None} after {it} sweeps: kernel {got!r}, plain "
        f"{plain!r}, f64 {f64!r}; relative differences {diff}; ms by turns "
        f"{turns}; bound {bound:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB)")
    return row


def dropped_grid():
    """The 1M grid with ``DROP`` of its bins dropped and a kNN-6 graph of
    what is left, prepared: (problem, prepare seconds)."""
    from flashdeconv_tpu_torch.utils import build_knn_graph

    coords, _ = knn_graph(SPOTS, False)
    t0 = time.perf_counter()
    dropped_coords = coords[drop_mask(SPOTS)]
    dropped_A = build_knn_graph(dropped_coords, k=6)
    log(f"[rest] 1M grid with {DROP:.0%} of its bins dropped: "
        f"{dropped_coords.shape[0]} spots, kNN-6 graph made in "
        f"{time.perf_counter() - t0:.1f} s")
    dropped, dropped_s = prepare_on(dropped_coords, dropped_A, TYPES)
    rest_tier(dropped, "1M 1%-dropped grid")
    return dropped, dropped_s


def rest_stats(t) -> str:
    """Bands, halo, rest edges and touched spots of a fused tier."""
    touched = int(torch.unique(t.rest_touched).numel())
    edges = int((t.rest_slot_cols[:, :touched] != 0).sum())
    return (f"{len(t.offsets)} bands, halo {max(abs(o) for o in t.offsets)} "
            f"(h = {t.h} blocks of {t.block}), {edges} rest edges over "
            f"{touched} touched spots, T = {t.rest_touched.numel()} columns "
            f"after padding, R = {t.rest_slot_cols.shape[0]} slots")


def rest_args(prob):
    """Kernel #1's arguments on a seeded carry of a fused tier with the rest
    stream, its ``ns_rest`` refreshed from that carry, and a whole sweep
    of the solve loop on those arguments (the rest update, then the
    launch): ``(args, ns_rest, sweep(*args, out))``."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    carry = bcd.to_fused_carry(seeded_beta(prob), t.h, t.block)
    inv = bcd.gs_inv_den(t.XtX, t.nnb, lam).contiguous()
    nsr = bcd.rest_ns_update(torch.zeros_like(t.Xty_t), carry,
                             t.rest_touched, t.rest_slot_cols)

    def sweep(*a, out):
        bcd.rest_ns_update(nsr, carry, t.rest_touched, t.rest_slot_cols)
        bcd.fused_banded_sweep(*a, out=out, ns_rest_t=nsr)

    return (carry, t.Xty_t, t.XtX, t.masks, inv, lam, rho, t.offsets, t.h,
            t.block), nsr, sweep


def check_rest_kernel(args, nsr, label: str) -> float:
    """One sweep with ``ns_rest``, kernel against plain; max |err|."""
    from flashdeconv_tpu_torch.ops import bcd

    ref, rd, ra = bcd.fused_banded_sweep_reference(*args, ns_rest_t=nsr)
    got, d, a = bcd.fused_banded_sweep(*args, ns_rest_t=nsr)
    err = check_close(got, ref, d, rd, a, ra, label)
    pad = args[8] * args[9]
    if not ((got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()):
        raise AssertionError(f"{label}: pad slabs are not zero")
    return err


def phase_rest_kernel(prob, label: str) -> dict:
    """Kernel #1 with ``ns_rest`` on a fused tier with the rest stream:
    against its plain version, then by CUDA events in turns with it; then,
    in turns, the rest update alone, the whole fused+rest sweep (update and
    launch) and the unfused banded sweep on the same operands (plain-torch
    band and rest sums, then kernel #2). Returns the kernels line's row."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    args, nsr, fused_sweep = rest_args(prob)
    carry, inv, lam, rho = args[0], args[4], args[5], args[6]

    def update(*_, out):
        bcd.rest_ns_update(nsr, carry, t.rest_touched, t.rest_slot_cols)

    unfused = t.unfused()
    beta_t = bcd.from_fused_carry(carry, t.h, t.block).T.contiguous()
    uargs = (beta_t, t.Xty_t, t.offsets, unfused.masks, unfused.rest,
             bcd.gs_pass_fn(t.XtX, t.nnb, lam, rho))
    with bcd.full_f32_matmul():
        err = check_rest_kernel(args, nsr, label)
        ms = in_turns(functools.partial(bcd.fused_banded_sweep_reference,
                                        ns_rest_t=nsr),
                      functools.partial(bcd.fused_banded_sweep,
                                        ns_rest_t=nsr),
                      args, torch.empty_like(carry))
        turns = {"update": [], "fused+rest sweep": [], "unfused sweep": []}
        spare, uspare = torch.empty_like(carry), torch.empty_like(beta_t)
        for name in ("unfused sweep", "fused+rest sweep", "update", "update",
                     "fused+rest sweep", "unfused sweep"):
            if name == "unfused sweep":
                turns[name].append(time_sweeps(bcd.bcd_sweep_banded, uargs,
                                               uspare))
            else:
                turns[name].append(time_sweeps(
                    update if name == "update" else fused_sweep, args, spare))
    K, n_ext = carry.shape
    n = prob.n_solve
    n_bytes = 4.0 * K * (2 * n_ext + 3 * n) + t.masks.numel() + 4.0 * K * K
    bound, by = bound_ms(n_bytes, gs_ops(K, n) + K * float(t.masks.sum())
                         + K * n)
    log(f"[kernel] fused_banded_sweep with ns_rest {label}: K={K} "
        f"{rest_stats(t)}; max_abs_err={err:.3e}; per sweep kernel "
        f"{ms['kernel']} ms, plain {ms['plain']} ms (plain, kernel, kernel, "
        f"plain); bound {bound:.4f} ms ({by}, {n_bytes / 1e9:.4f} GB)")
    log(f"[kernel] rest stream {label}, ms per sweep (CUDA events, "
        f"{SWEEPS} sweeps, in turns unfused, fused, update, update, fused, "
        f"unfused): {turns}")
    return {"K": K, "max_abs_err": err, "ms": float(np.mean(ms["kernel"])),
            "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
            "bound_by": by}


def phase_band_cap(grid, capped) -> None:
    """The band-cap question on the card: the capped 1M grid's sweep (its
    near-empty bands spilled into the rest stream: kernel with ``ns_rest``,
    plus the rest update) beside the plain 1M grid's sweep (all bands, no
    rest), by CUDA events in turns; the capped kernel first held against
    its plain version."""
    from flashdeconv_tpu_torch.ops import bcd

    t = capped.tier
    args, nsr, capped_sweep = rest_args(capped)
    g = grid.tier
    gcarry = bcd.to_fused_carry(seeded_beta(grid), g.h, g.block)
    gargs = (gcarry, g.Xty_t, g.XtX, g.masks,
             bcd.gs_inv_den(g.XtX, g.nnb, 0.1).contiguous(), 0.1,
             0.01 * grid.mean_diag, g.offsets, g.h, g.block)
    turns = {"plain grid": [], "capped grid": []}
    with bcd.full_f32_matmul():
        err = check_rest_kernel(args, nsr, "capped 1M grid")
        for name in ("plain grid", "capped grid", "capped grid",
                     "plain grid"):
            if name == "plain grid":
                turns[name].append(time_sweeps(bcd.fused_banded_sweep, gargs,
                                               torch.empty_like(gcarry)))
            else:
                turns[name].append(time_sweeps(capped_sweep, args,
                                               torch.empty_like(args[0])))
    log(f"[band cap] 1M grid + {RESCUE_EDGES} long edges, rescued: "
        f"{rest_stats(t)}; kernel vs plain max_abs_err {err:.3e}; ms per "
        f"sweep (CUDA events, {SWEEPS} sweeps): {len(g.offsets)}-band plain "
        f"grid {turns['plain grid']}, {len(t.offsets)}-band capped grid with "
        f"the rest update {turns['capped grid']} (plain, capped, capped, "
        f"plain)")


def rest_tier(prob, label: str) -> None:
    """``prob`` must have taken the fused tier with rest tables."""
    if not (prob.use_fused_banded and prob.tier.rest_touched is not None):
        raise AssertionError(f"{label} did not take the fused tier with the "
                             "rest stream")
    log(f"[rest] {label}: {prob.n_spots} spots, fused tier, "
        f"{rest_stats(prob.tier)}")


@functools.lru_cache(maxsize=1)
def dropped_fit_counts():
    """The 262,144-spot grid fit's counts with 1 % of the bins dropped."""
    Y, X, truth = grid_fit_counts()
    keep = drop_mask(Y.shape[0])
    return Y[keep], X, truth[keep]


# -- the main paths ---------------------------------------------------------------

def objective_kernel(prob) -> bool:
    """Whether ``prob``'s solves launch the objective kernel, once a solve:
    the fused tier at K <= 56 (f32 on the card)."""
    from flashdeconv_tpu_torch.ops import bcd

    return (prob.use_fused_banded and prob.tier.Xty_t.dtype == torch.float32
            and prob.n_types <= bcd.OBJECTIVE_KERNEL_MAX_K)


def neighbor_sum_calls(prob) -> int:
    """Launches of the neighbour-sum kernel in each sweep of ``prob``'s
    solves, and in each objective: on the card at f32, one for the gather
    tier's table and one more for its hubs' overflow table, one for the
    unfused banded tier's rest table where it has one; none on the fused
    tier or in f64."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    if t.Xty_t.dtype != torch.float32:
        return 0
    if isinstance(t, bcd.GatherTier):
        return 1 + (t.overflow is not None)
    if isinstance(t, bcd.BandedTier):
        return int(t.rest.shape[0] > 0)
    return 0


def plain_solve(prob):
    """The solve's loop over the plain version of its kernel (and, on the
    fused tier, of the objective kernel; on the gather tier, of the
    neighbour-sum kernel), on the card: (beta (n_spots, K) f64 on the
    host, sweeps, final objective)."""
    from unittest import mock

    from flashdeconv_tpu_torch.ops import bcd

    kern = {bcd.FusedBandedTier: "fused_banded_sweep",
            bcd.GatherTier: "coordinate_descent_block"}[type(prob.tier)]
    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * prob.mean_diag)
    with mock.patch.object(bcd, kern, getattr(bcd, f"{kern}_reference")), \
            mock.patch.object(bcd, "objective_terms_banded_fused",
                              bcd.objective_terms_banded_fused_reference), \
            mock.patch.object(bcd, "neighbor_sum_kernel_takes",
                              lambda t: False):
        beta, it, _, _, objectives = bcd.fused_solve(
            None, prob.tier, prob._inv_perm_d, lam, rho, SOLVE["tol"],
            SOLVE["max_iter"], prob.n_spots)
    return beta.double().cpu().numpy(), it, objectives[-1]


def phase_solve(prob, prepare_s: float, label: str) -> int:
    """Two solves through the kernel (bitwise equal), and one through the
    plain version on the card as the reference. Returns the sweeps."""
    sweeps, betas = 0, []
    for name in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, info = prob.solve(**SOLVE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not (info["converged"] and np.isfinite(info["final_objective"])
                and np.isfinite(beta).all() and (beta >= 0).all()):
            raise AssertionError(f"bad solve: {info}")
        sweeps += info["n_iterations"]
        betas.append(beta)
        log(f"[solve] {label} {name}: {dt:.4f} s, {prob.n_spots / dt:.1f} "
            f"spots/s, {info['n_iterations']} sweeps, objective "
            f"{info['final_objective']:.6g}, rel {info['final_change']:.3e}, "
            f"peak {torch.cuda.max_memory_allocated()} B allocated")
    log(f"[solve] {label} prepare {prepare_s:.3f} s (host precompute + copy)")
    if not np.array_equal(betas[0], betas[1]):
        raise AssertionError("two kernel solves are not bitwise equal")
    REFERENCE[label] = (betas[1], info["n_iterations"])

    ref, it, objective = plain_solve(prob)
    diff = float(np.abs(betas[1] - ref).max())
    rel = abs(info["final_objective"] - objective) / abs(objective)
    log(f"[solve] {label} plain-version solve: {it} sweeps, max |beta - "
        f"beta_plain| = {diff:.3e}, objective {objective:.6g} (relative "
        f"difference {rel:.3e}); two kernel solves bitwise equal")
    if it != info["n_iterations"] or diff > 1e-4:
        raise AssertionError("kernel solve disagrees with the plain solve")
    if objective_kernel(prob) and rel > OBJECTIVE_RTOL:
        raise AssertionError("the objective kernel's final objective "
                             "disagrees with the plain solve's")
    return sweeps


def phase_profile(prob, label: str, reps: int = 3) -> None:
    """Warm solves of ``prob``, split as ``BCDProblem.solve`` is:
    ``fused_solve`` (ended by a synchronize) and the fetch of beta to host
    f64 (``fetch_to_host``); beside them the fetch's parts alone, on the
    same beta: the contiguous copy on the card, the copy of its f32 bytes
    into one pinned buffer, and the host cast to f64 into a fresh array
    and into one already written (no page faults). ``reps`` solves are
    timed by the host clock with no profiler, then ``reps`` more run under
    ``torch.profiler``, whose table is printed."""
    from torch.profiler import ProfilerActivity, profile

    from flashdeconv_tpu_torch.core.solver import fetch_to_host
    from flashdeconv_tpu_torch.ops import bcd

    lam, rho = bcd.f32(0.1), bcd.f32(0.01 * prob.mean_diag)
    touched = torch.zeros((prob.n_spots, prob.n_types), dtype=torch.float64)

    def timed_solve(run):
        t = [time.perf_counter()]
        beta_d, n_iter = bcd.fused_solve(
            None, prob.tier, prob._inv_perm_d, lam, rho, 1e-4, 100,
            prob.n_spots,
        )[:2]
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        fetch_to_host(beta_d)
        t.append(time.perf_counter())
        flat = beta_d.contiguous()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        pinned = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        t.append(time.perf_counter())
        pinned.copy_(flat)
        t.append(time.perf_counter())
        pinned.to(torch.float64)
        t.append(time.perf_counter())
        touched.copy_(pinned)
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        log(f"[profile] {label} {run}: {n_iter} sweeps; fused_solve "
            f"{ms[0]:.3f} ms; fetch_to_host {ms[1]:.3f} ms; its parts "
            f"alone: contiguous on the card {ms[2]:.3f} ms, pinned "
            f"allocation {ms[3]:.3f} ms, copy to pinned {ms[4]:.3f} ms, "
            f"host cast to a fresh f64 array {ms[5]:.3f} ms, to a written "
            f"one {ms[6]:.3f} ms")

    timed_solve("warm-up solve")
    for rep in range(reps):
        timed_solve(f"warm solve {rep}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for rep in range(reps):
            timed_solve(f"warm solve {rep} under the profiler")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=25))


@functools.lru_cache(maxsize=1)
def grid_fit_counts():
    """The 262,144-spot grid fit's counts, made once for the single-device
    fit and the 2-shard mesh fit (about a minute of host time each)."""
    from flashdeconv_tpu_torch.utils import grid_coords

    return synthetic_counts(grid_coords(side=FIT_SIDE), float(FIT_SIDE),
                            FIT_GENES, TYPES)


def phase_fit(label: str, coords, extent: float, n_genes: int,
              runs=("cold", "warm"), dense: bool = False,
              n_hvg: int = 2000, n_types: int = TYPES, model_kw=None,
              counts=None, **recipe) -> int:
    """``fit_transform`` of synthetic counts (CSR, or dense with ``dense``;
    ``recipe`` goes to :func:`synthetic_counts`; or ``counts()``, which
    returns them, made once) over ``coords`` by a
    ``FlashDeconv(**model_kw)`` on the host path (``device_outputs=False``
    unless ``model_kw`` says otherwise); Pearson against the generating
    proportions must pass 0.9. Returns sweeps."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.utils import compute_correlation

    t0 = time.perf_counter()
    Y, X, truth = counts() if counts else synthetic_counts(
        coords, extent, n_genes, n_types, dense=dense, **recipe)
    nnz = np.count_nonzero(Y) if dense else Y.nnz
    log(f"[fit] {label}: {'dense' if dense else 'CSR'} counts {Y.shape} "
        f"nnz {nnz} {counts.__name__ + '()' if counts else 'made'} in "
        f"{time.perf_counter() - t0:.1f} s")
    if dense:  # the dense sketch's copy to the card, on its own
        t0 = time.perf_counter()
        on_card = torch.as_tensor(Y, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        log(f"[fit] {label}: f64 counts cast to f32 and copied to the card "
            f"({on_card.nbytes} B) in {time.perf_counter() - t0:.3f} s")
        del on_card
    sweeps = 0
    for name in runs:  # the first includes first-use host builds
        model = FlashDeconv(sketch_dim=SKETCH, n_hvg=n_hvg,
                            **{"device_outputs": False, **(model_kw or {})})
        t0 = time.perf_counter()
        props = model.fit_transform(Y, X, coords)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        info = model.info_
        pearson = float(compute_correlation(props, truth))
        log(f"[fit] {label} {name} fit_transform {dt:.3f} s, "
            f"{len(model.gene_idx_)} genes, {info['n_iterations']} sweeps, "
            f"converged {info['converged']}, pearson vs truth "
            f"{pearson:.4f}, lambda {model.lambda_used_:.6g}")
        log("[fit] stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in model.timings_.items()))
        if not np.allclose(props.sum(axis=1), 1.0, atol=1e-9):
            raise AssertionError("proportion rows do not sum to 1")
        if not pearson > 0.9:
            raise AssertionError(f"{label}: pearson {pearson} <= 0.9")
        sweeps += info["n_iterations"]
    return sweeps


def phase_fetch(prob, label: str, reps: int = 5,
                solves: bool = True) -> None:
    """The fetch of beta, the old way against the new, on one device beta
    of ``prob`` (the view ``fused_solve`` leaves, as ``solve`` fetches it):
    the former f64 cast on the card and pageable copy, against
    ``fetch_to_host`` (a contiguous f32 copy on the card, the pinned
    staging ring, the cast on the host); both bit for bit ``.cpu()``. A
    cold fetch first, with torch's pinned-host cache emptied. Then, in
    turns over ``reps`` warm rounds: with ``solves``, ``solve()`` and
    ``solve(return_device=True)`` ended by a synchronize, and the two
    fetches alone. Host clock, each call ended by a synchronize."""
    from flashdeconv_tpu_torch.core.solver import fetch_to_host
    from flashdeconv_tpu_torch.ops import bcd

    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * prob.mean_diag)
    view = bcd.fused_solve(None, prob.tier, prob._inv_perm_d, lam, rho,
                           SOLVE["tol"], SOLVE["max_iter"], prob.n_spots)[0]
    torch.cuda.synchronize()
    ref = view.cpu().double().numpy()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, out

    calls = {
        "old fetch": lambda: view.to("cpu", torch.float64).numpy(),
        "new fetch": lambda: fetch_to_host(view),
    }
    if solves:
        calls["solve()"] = lambda: prob.solve(**SOLVE)[0]
        calls["solve(return_device=True)"] = lambda: prob.solve(
            return_device=True, **SOLVE)[0]
    empty_cache = getattr(torch._C, "_host_emptyCache", None)
    if empty_cache is not None:
        empty_cache()
        ms, got = timed(calls["new fetch"])
        if not np.array_equal(got, ref):
            raise AssertionError(f"{label}: the cold fetch is not .cpu()")
        alloc = torch.cuda.host_memory_stats().get("host_alloc_time.total")
        log(f"[fetch] {label}: cold new fetch {ms:.3f} ms (pinned staging "
            f"allocated in the call; torch's pinned allocations so far took "
            f"{alloc} us), {view.numel() * 4} B of f32")
    else:
        log(f"[fetch] {label}: cold fetch not measured (no pinned-host "
            "cache to empty in this torch)")
    times = {name: [] for name in calls}
    for rep in range(reps):
        order = list(calls) if rep % 2 == 0 else list(calls)[::-1]
        for name in order:
            ms, got = timed(calls[name])
            times[name].append(ms)
            if name.endswith("fetch") or name == "solve()":
                if not np.array_equal(got, ref):
                    raise AssertionError(f"{label}: {name} is not .cpu()")
            else:
                if not torch.equal(got.double().cpu(),
                                   torch.from_numpy(ref)):
                    raise AssertionError(f"{label}: {name} differs")
    for name, ms in times.items():
        log(f"[fetch] {label}: {name} warm ms "
            f"{' '.join(f'{t:.3f}' for t in ms)} (median "
            f"{float(np.median(ms)):.3f})")
    log(f"[fetch] {label}: every fetch bit for bit .cpu() of the device "
        "beta")


def grid_outputs_model(**kw):
    from flashdeconv_tpu_torch import FlashDeconv

    return FlashDeconv(sketch_dim=SKETCH, **kw)


def outputs_fit(label: str, model, Y, X, coords, truth):
    """One timed ``fit`` of ``model``: (model, what the fit left on the card
    — {"beta", "proportions"} -> bool, read before Pearson > 0.9 reads the
    proportions)."""
    from flashdeconv_tpu_torch.utils import compute_correlation

    t0 = time.perf_counter()
    model.fit(Y, X, coords)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    on_card = {"beta": model._beta_dev is not None,
               "proportions": model._props_dev is not None}
    pearson = float(compute_correlation(model.proportions_, truth))
    log(f"[outputs] {label}: fit {dt:.3f} s, {model.info_['n_iterations']} "
        f"sweeps, pearson {pearson:.4f}; stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in model.timings_.items()))
    if not pearson > 0.9:
        raise AssertionError(f"{label}: pearson {pearson} <= 0.9")
    return model, on_card


def phase_outputs() -> dict:
    """The fit's outputs on the 262k grid fit's counts (no second draw):
    the host-path fit, then three device-output fits held to the JAX
    package's bounds against it (the default ``cuda`` fit: row sums within
    1e-5, proportions and the lazy beta within 1e-6; ``outputs=
    ("dominant",)``: the argmax where the host top two differ by > 1e-5,
    lazy proportions within 1e-6; ``fetch_dtype="float16"``: within
    5e-4); ``fit_lambda_path`` at its 5 default lambdas against a cold
    solve at each lambda on one prepared problem; and the counts stacked
    twice on a 512 x 1024 grid (524,288 spots), which stream their Xty to
    the card in chunks, against the same fit unstreamed (beta bit for
    bit). Returns the launches the path must show: kernel #1 a sweep, the
    objective kernel a solve."""
    from scipy import sparse

    from flashdeconv_tpu_torch.utils import grid_coords
    from flashdeconv_tpu_torch.utils.timing import StageTimer

    Y, X, truth = grid_fit_counts()
    coords = grid_coords(side=FIT_SIDE)
    host, _ = outputs_fit("262k grid, host path (device_outputs=False)",
                          grid_outputs_model(device_outputs=False), Y, X,
                          coords, truth)
    sweeps = host.info_["n_iterations"]
    P = host.proportions_

    dev, on_card = outputs_fit("262k grid, default (device outputs)",
                               grid_outputs_model(), Y, X, coords, truth)
    if not on_card["beta"]:
        raise AssertionError("the default cuda fit fetched beta")
    rows = float(np.abs(dev.proportions_.sum(axis=1) - 1.0).max())
    dp = float(np.abs(dev.proportions_ - P).max())
    t0 = time.perf_counter()
    beta = dev.beta_
    lazy_ms = (time.perf_counter() - t0) * 1e3
    db = float(np.abs(beta - host.beta_).max())
    log(f"[outputs] default: max |row sum - 1| {rows:.3e}, max |P - "
        f"P_host| {dp:.3e}, lazy beta_ fetched in {lazy_ms:.3f} ms, max "
        f"|beta - beta_host| {db:.3e} (bitwise {np.array_equal(beta, host.beta_)})")
    if not (rows <= 1e-5 and dp <= 1e-6 and db <= 1e-6):
        raise AssertionError("device outputs outside their bounds")
    sweeps += dev.info_["n_iterations"]

    dom, on_card = outputs_fit("262k grid, outputs=('dominant',)",
                               grid_outputs_model(outputs=("dominant",)), Y,
                               X, coords, truth)
    top2 = np.sort(P, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    agree = np.array_equal(dom.dominant_[clear], np.argmax(P, 1)[clear])
    if not on_card["proportions"]:
        raise AssertionError("outputs=('dominant',) fetched proportions")
    dpl = float(np.abs(dom.proportions_ - P).max())
    log(f"[outputs] dominant: {dom.dominant_.dtype} argmax agrees with the "
        f"host path's at {int(clear.sum())} of {clear.size} spots whose top "
        f"two differ by > 1e-5: {agree}; lazy proportions max |P - P_host| "
        f"{dpl:.3e}")
    if not (agree and dpl <= 1e-6):
        raise AssertionError("outputs=('dominant',) outside its bounds")
    sweeps += dom.info_["n_iterations"]

    f16, _ = outputs_fit("262k grid, fetch_dtype='float16'",
                         grid_outputs_model(fetch_dtype="float16"), Y, X,
                         coords, truth)
    d16 = float(np.abs(f16.proportions_ - P).max())
    log(f"[outputs] float16: max |P - P_host| {d16:.3e} (bound 5e-4)")
    if not d16 <= 5e-4:
        raise AssertionError("fetch_dtype='float16' outside its bound")
    sweeps += f16.info_["n_iterations"]
    del dev, dom, f16

    # The lambda path, and a cold solve at each lambda on one prepared
    # problem (stages 1-4 and the prepare of the model's own path code).
    model = grid_outputs_model()
    t0 = time.perf_counter()
    path = model.fit_lambda_path(Y, X, coords)
    torch.cuda.synchronize()
    log(f"[lambda path] 5 default lambdas: {time.perf_counter() - t0:.3f} s "
        "with stages 1-4 and one prepare; stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in model.timings_.items()))
    cold_model = grid_outputs_model()
    operands = cold_model._pipeline_operands(Y, X, coords, None,
                                             StageTimer())
    prob = cold_model._prepare(*operands, coords)
    for r in path:
        t0 = time.perf_counter()
        beta, info = prob.solve(lambda_=r["lambda"],
                                rho=cold_model.rho_sparsity,
                                max_iter=cold_model.max_iter,
                                tol=cold_model.tol)
        dt = time.perf_counter() - t0
        diff = float(np.abs(beta - r["beta"]).max())
        log(f"[lambda path] lambda {r['lambda']:.6g}: warm-started "
            f"{r['info']['n_iterations']} sweeps, cold {info['n_iterations']}"
            f" ({dt:.3f} s), max |beta_path - beta_cold| {diff:.3e}")
        if not (info["converged"] and r["info"]["converged"]):
            raise AssertionError("a lambda-path solve did not converge")
        sweeps += r["info"]["n_iterations"] + info["n_iterations"]
    solves = 4 + 2 * len(path)  # the four fits above, path and cold solves
    del prob, operands

    # The streamed feed: the counts twice over (524,288 spots).
    t0 = time.perf_counter()
    Y2 = sparse.vstack([Y, Y], format="csr")
    coords2 = np.vstack([coords, coords + [0.0, FIT_SIDE]])
    truth2 = np.vstack([truth, truth])
    log(f"[streamed] counts stacked twice: {Y2.shape}, nnz {Y2.nnz}, in "
        f"{time.perf_counter() - t0:.1f} s")
    streamed = grid_outputs_model()
    if not streamed._streams_xty(Y2.shape[0]):
        raise AssertionError("the 524,288-spot fit does not stream")
    streamed, _ = outputs_fit("524k grid, streamed Xty", streamed, Y2, X,
                              coords2, truth2)
    whole = grid_outputs_model()
    whole._streams_xty = lambda n_rows: False
    whole, _ = outputs_fit("524k grid, Xty copied whole", whole, Y2, X,
                           coords2, truth2)
    same = np.array_equal(streamed.beta_, whole.beta_)
    log(f"[streamed] beta of the streamed fit bit for bit the unstreamed "
        f"fit's: {same}; sweeps {streamed.info_['n_iterations']} / "
        f"{whole.info_['n_iterations']}")
    if not same:
        raise AssertionError("the streamed feed changed beta")
    return {"fused_banded_sweep": sweeps + streamed.info_["n_iterations"]
            + whole.info_["n_iterations"],
            "fused_banded_objective": solves + 2}


def phase_timing(prob, label: str, kernel_ms: float) -> int:
    """The sweep-timing protocol (``utils/timing``) on ``prob``'s fused
    tier: ``fused_sweep_timer_for`` and ``fori_difference_windows`` (runs
    of 5 and 30 sweeps, 12 windows), each run's sweeps queued with no host
    read and ended by one scalar read; the windows' min and median beside
    the kernel's CUDA-event time per launch from this run. Returns the
    sweeps the timer launched."""
    from flashdeconv_tpu_torch.utils.timing import (
        fori_difference_windows,
        fused_sweep_timer_for,
    )

    timed = fused_sweep_timer_for(prob, SOLVE["lambda_"], SOLVE["rho"])
    asked = []
    t0 = time.perf_counter()
    windows = fori_difference_windows(
        lambda n: asked.append(n) or timed(n))
    ms = [w * 1e3 for w in windows]
    lo, med = min(ms), float(np.median(ms))
    log(f"[timing] {label}: {len(ms)} windows of 30 less 5 sweeps "
        f"({sum(asked)} sweeps in {len(asked)} runs, "
        f"{time.perf_counter() - t0:.2f} s): min {lo:.4f} ms, median "
        f"{med:.4f} ms a sweep (median / min {med / lo:.3f}); the kernel "
        f"alone {kernel_ms:.4f} ms a launch (CUDA events); windows ms "
        f"{' '.join(f'{m:.4f}' for m in ms)}")
    return sum(asked)


def phase_trace() -> int:
    """One fit of the 262k grid's counts (``grid_fit_counts``, made once)
    with ``FLASHDECONV_TRACE_DIR`` set to a temporary directory, beside
    the same fit untraced: the directory must hold exactly ``sketch/`` and
    ``bcd_solve/``, each one Chrome trace that parses; the ``bcd_solve``
    trace must name kernel #1's ``__global__`` once a sweep (the kernels
    are launched through ctypes, so only CUPTI's record shows them); and
    the traced fit's beta must be bitwise the untraced one's. Prints both
    fits' seconds. Returns the sweeps of both fits."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.utils import grid_coords

    Y, X, _ = grid_fit_counts()
    coords = grid_coords(side=FIT_SIDE)

    def fit():
        model = FlashDeconv(sketch_dim=SKETCH, n_hvg=2000,
                            device_outputs=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit(Y, X, coords)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    plain, plain_s = fit()
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["FLASHDECONV_TRACE_DIR"] = tmp
        try:
            traced, traced_s = fit()
        finally:
            del os.environ["FLASHDECONV_TRACE_DIR"]
        stages = sorted(p.name for p in Path(tmp).iterdir())
        if stages != ["bcd_solve", "sketch"]:
            raise AssertionError(f"trace subdirectories {stages}")
        events, sizes = {}, {}
        for stage in stages:
            files = list((Path(tmp) / stage).glob("*.pt.trace.json"))
            if len(files) != 1:
                raise AssertionError(f"{stage}: trace files {files}")
            sizes[stage] = files[0].stat().st_size
            events[stage] = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events["bcd_solve"] if e.get("cat") == "kernel"]
    sweeps = [e for e in kernels
              if "fused_banded_sweep_kernel" in e.get("name", "")]
    names = sorted({e["name"].split("(")[0] for e in kernels})
    n_iter = traced.info_["n_iterations"]
    log(f"[trace] 262k grid fit: {plain_s:.3f} s untraced, {traced_s:.3f} "
        f"s traced; trace bytes {sizes}; bcd_solve: {len(events['bcd_solve'])}"
        f" events, {len(kernels)} device kernels, {len(sweeps)} of kernel #1 "
        f"against {n_iter} sweeps; kernel names {names}")
    if len(sweeps) != n_iter:
        raise AssertionError("the bcd_solve trace does not name kernel #1 "
                             "once a sweep")
    if not np.array_equal(traced.beta_, plain.beta_):
        raise AssertionError("the traced fit's beta differs")
    log(f"[trace] sketch: {len(events['sketch'])} events; the traced fit's "
        "beta bit for bit the untraced one's")
    return plain.info_["n_iterations"] + n_iter


def phase_arena() -> dict:
    """The host arena (``utils/hostmem``), last of all phases: ``mallopt``
    changes the allocator for the rest of the process. On a freshly
    prepared 1M x 20 grid, ``ARENA_ROUNDS`` warm rounds, each a host-path
    ``solve()`` and the same solve split into ``fused_solve`` (ended by a
    synchronize) and ``fetch_to_host``; then ``reserve_host_arena
    (ARENA_GB)``, timed; then as many rounds again. Every beta must be
    bitwise the first solve's. Host clock, each call ended by a
    synchronize. Returns the launches the phase must show: kernel #1 a
    sweep, the objective kernel a solve."""
    from flashdeconv_tpu_torch.core.solver import fetch_to_host
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.utils import hostmem

    prob, prep_s = prepare(SPOTS, TYPES)
    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * prob.mean_diag)
    ref, info = prob.solve(**SOLVE)
    sweeps = info["n_iterations"]

    def rounds(tag: str) -> None:
        nonlocal sweeps
        ms = {"solve()": [], "fused_solve": [], "fetch_to_host": []}
        for _ in range(ARENA_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beta, info = prob.solve(**SOLVE)
            t1 = time.perf_counter()
            if not np.array_equal(beta, ref):
                raise AssertionError(f"[arena] {tag}: solve() differs")
            del beta
            t2 = time.perf_counter()
            beta_d, n_iter = bcd.fused_solve(
                None, prob.tier, prob._inv_perm_d, lam, rho, SOLVE["tol"],
                SOLVE["max_iter"], prob.n_spots)[:2]
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host = fetch_to_host(beta_d)
            t4 = time.perf_counter()
            if not np.array_equal(host, ref):
                raise AssertionError(f"[arena] {tag}: the fetch differs")
            del host, beta_d
            sweeps += info["n_iterations"] + n_iter
            for name, dt in (("solve()", t1 - t0), ("fused_solve", t3 - t2),
                             ("fetch_to_host", t4 - t3)):
                ms[name].append(dt * 1e3)
        log(f"[arena] 1M grid {tag}: " + "; ".join(
            f"{name} ms {' '.join(f'{t:.3f}' for t in v)} (median "
            f"{float(np.median(v)):.3f})" for name, v in ms.items()))

    log(f"[arena] 1M grid prepared in {prep_s:.3f} s; {ARENA_ROUNDS} warm "
        f"rounds before and after reserve_host_arena({ARENA_GB})")
    rounds("before the arena")
    t0 = time.perf_counter()
    if not hostmem.reserve_host_arena(ARENA_GB):
        raise AssertionError("reserve_host_arena found no glibc mallopt")
    log(f"[arena] reserve_host_arena({ARENA_GB}) "
        f"{time.perf_counter() - t0:.3f} s")
    rounds("after the arena")
    log("[arena] every beta bit for bit the first solve's")
    return {"fused_banded_sweep": sweeps,
            "fused_banded_objective": 1 + 2 * 2 * ARENA_ROUNDS}


def phase_dense_fit() -> dict:
    """The Xenium 5K-like dense fit, cold and warm: every gene kept, so
    each fit projects Y (G >= 4096, N >= 1024) through the CountSketch
    kernel once; X (K rows) takes the matmul. Returns the launches the
    path must show."""
    sweeps = phase_fit("Xenium 5K-like dense", irregular_coords(CELLS),
                       float(np.sqrt(CELLS)), DENSE_GENES, dense=True,
                       n_hvg=DENSE_GENES)
    return {"coordinate_descent_block": sweeps, "countsketch_project": 2,
            "neighbor_sum": sweeps + 2}


def phase_profile_dense_sketch() -> None:
    """The dense fit's sketch stage on its own: gene selection and log-CPM
    of the Xenium 5K-like counts as the fit makes them, then
    ``sketch_data`` (the fit's call) twice by the host clock and once under
    ``torch.profiler``, whose table (by host time) is printed."""
    from torch.profiler import ProfilerActivity, profile

    from flashdeconv_tpu_torch.core.preprocess import preprocess_data
    from flashdeconv_tpu_torch.core.sketching import sketch_data
    from flashdeconv_tpu_torch.utils.genes import select_informative_genes

    Y, X, _ = synthetic_counts(irregular_coords(CELLS), float(np.sqrt(CELLS)),
                               DENSE_GENES, TYPES, dense=True)
    gene_idx, lev = select_informative_genes(Y, X, n_hvg=DENSE_GENES)
    Y_tilde, X_tilde = preprocess_data(Y[:, gene_idx], X[:, gene_idx],
                                       "log_cpm")
    del Y

    def timed(run):
        t0 = time.perf_counter()
        sketch_data(Y_tilde, X_tilde, SKETCH, lev, random_state=0,
                    device="cuda")
        log(f"[profile] dense sketch {run}: {time.perf_counter() - t0:.3f} "
            f"s for {Y_tilde.shape} f64")

    for run in ("first call", "second call"):
        timed(run)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed("under the profiler")
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=20))


def phase_sub_kernel(prob, label: str) -> dict:
    """Kernel #1's sub-range form on a fused-tier problem's operands: the
    interior call and both boundary calls of a split sweep, each alone (a
    sub-carry) against the plain version, and the three into one full
    carry, which must hold the whole sweep's data columns bit for bit with
    its pads untouched. Then the interior call (into a full carry) timed
    in turns with its plain version, and the three calls against the
    whole call. Returns the interior call's row of the kernels line."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    carry = bcd.to_fused_carry(seeded_beta(prob), t.h, t.block)
    inv = bcd.gs_inv_den(t.XtX, t.nnb, lam).contiguous()
    args = (carry, t.Xty_t, t.XtX, t.masks, inv, lam, rho, t.offsets, t.h,
            t.block)
    h, m, pad = t.h, prob.n_solve // t.block, t.h * t.block
    subs = {"interior": (h, h, m - 2 * h), "left": (0, 0, h),
            "right": (m - h, m - h, h)}
    errs = {}
    with bcd.full_f32_matmul():
        whole, wd, wa = bcd.fused_banded_sweep(*args)
        out = torch.full_like(carry, float("nan"))
        stats = []
        for name, sub in subs.items():
            ref, rd, ra = bcd.fused_banded_sweep_reference(*args, sub=sub)
            got, d, a = bcd.fused_banded_sweep(*args, sub=sub)
            errs[name] = check_close(got, ref, d, rd, a, ra,
                                     f"{label} {name}")
            if not ((got[:, :pad] == 0).all() and (got[:, -pad:] == 0).all()):
                raise AssertionError(f"{label} {name}: sub-carry pads not 0")
            stats.append(bcd.fused_banded_sweep(*args, out=out, sub=sub)[1:])
            del ref, got
        torch.cuda.synchronize()
        same = (torch.equal(out[:, pad:-pad], whole[:, pad:-pad])
                and bool(torch.isnan(out[:, :pad]).all())
                and bool(torch.isnan(out[:, -pad:]).all())
                and max(float(d) for d, _ in stats) == float(wd)
                and max(float(a) for _, a in stats) == float(wa))
        log(f"[kernel] fused_banded_sweep sub-range {label}: K={t.XtX.shape[0]}"
            f" m={m} h={h} subs {subs}; max_abs_err vs plain {errs}; three "
            f"calls into one carry bitwise the whole sweep, pads untouched, "
            f"stats max equal: {same}")
        if not same:
            raise AssertionError(f"{label}: the split sweep is not the whole")
        interior = functools.partial(bcd.fused_banded_sweep,
                                     sub=subs["interior"])
        ms = in_turns(functools.partial(bcd.fused_banded_sweep_reference,
                                        sub=subs["interior"]),
                      interior, args, out)

        def split(*a, out):
            for sub in subs.values():
                bcd.fused_banded_sweep(*a, out=out, sub=sub)

        turns = {"whole": [], "split": []}
        spare = torch.empty_like(carry)
        for name in ("whole", "split", "split", "whole"):
            fn = split if name == "split" else bcd.fused_banded_sweep
            turns[name].append(time_sweeps(fn, args, spare))
    K = carry.shape[0]
    n_sub = (m - 2 * h) * t.block
    cols = slice(h * t.block, (m - h) * t.block)
    n_bytes = (4.0 * K * (n_sub + 2 * pad) + 4.0 * K * 3 * n_sub
               + t.masks[:, cols].numel() + 4.0 * K * K)
    bound, by = bound_ms(n_bytes, gs_ops(K, n_sub)
                         + K * float(t.masks[:, cols].sum()))
    log(f"[kernel] fused_banded_sweep sub-range {label}: interior call "
        f"({n_sub} spots) kernel {ms['kernel']} ms, plain {ms['plain']} ms "
        f"(plain, kernel, kernel, plain); bound {bound:.4f} ms ({by}); a "
        f"split sweep (three calls) {turns['split']} ms against the whole "
        f"sweep {turns['whole']} ms (whole, split, split, whole)")
    return {"K": K, "max_abs_err": max(errs.values()),
            "ms": float(np.mean(ms["kernel"])),
            "plain_ms": float(np.mean(ms["plain"])), "bound_ms": bound,
            "bound_by": by}


def card_mesh(n_shards: int):
    """A mesh of ``n_shards`` shards on card 0."""
    return (torch.device("cuda", 0),) * n_shards


def timed_mesh_solve(prob, label: str, ref) -> dict:
    """A cold and a warm ``solve`` of a prepared sharded problem: each must
    give the reference's sweeps and, for ``ref`` bitwise, its beta; within
    1e-5 otherwise. Returns the last info."""
    want, want_it, bitwise = ref
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, info = prob.solve(**SOLVE)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        diff = float(np.abs(beta - want).max())
        log(f"[mesh] {label} {run}: {dt:.4f} s, {prob.n_spots / dt:.1f} "
            f"spots/s, {info['n_iterations']} sweeps (single device "
            f"{want_it}), max |beta - beta_single| = {diff:.3e}, objective "
            f"{info['final_objective']:.6g}, peak "
            f"{torch.cuda.max_memory_allocated()} B allocated")
        ok = info["converged"] and info["n_iterations"] == want_it and (
            np.array_equal(beta, want) if bitwise else diff <= 1e-5)
        if not ok:
            raise AssertionError(f"{label}: the sharded solve disagrees "
                                 "with the single-device one")
    return info


def phase_sharded(halo: dict) -> dict:
    """The sharded main path (see the module docstring, item 5). Leaves the
    prepared halo problem in ``halo["prob"]``. Returns the launches the
    path must show."""
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd
    from flashdeconv_tpu_torch.utils import grid_coords

    want = {}

    def add(name, n):
        want[name] = want.get(name, 0) + n

    coords, A = knn_graph(SPOTS, False)
    for K, shard_counts, label in ((TYPES, MESH_SHARDS, "1M grid"),
                                   (128, (2,), "1M grid K=128")):
        Y, X, _ = make_problem(SPOTS, K, SKETCH)
        ref, ref_it = REFERENCE[label]
        whole = ("fused_banded_sweep_large_k"
                 if K > bcd.REGISTER_PASS_MAX_K else "fused_banded_sweep")
        for P in shard_counts:
            t0 = time.perf_counter()
            prob = prepare_sharded_bcd(Y, X, A, coords=coords,
                                       mesh=card_mesh(P))
            torch.cuda.synchronize()
            inner = prob._inner
            log(f"[mesh] {label} on {P} shards: prepare "
                f"{time.perf_counter() - t0:.3f} s, strategy "
                f"{prob.strategy}, fused {inner.use_fused}, {inner.n_local} "
                f"spots a shard, block {inner._fused_block}, h "
                f"{inner._fused_h}")
            if not (prob.strategy == "banded" and inner.use_fused):
                raise AssertionError(f"{label}: not the fused banded mesh")
            info = timed_mesh_solve(prob, f"{label} P={P} unsplit",
                                    (ref, ref_it, True))
            add(whole, 2 * P * info["n_iterations"])
            # The sweeps alone (no objective, no fetch), unsplit and split
            # in turns; each run's beta bitwise the single device's.
            loop_s = {False: [], True: []}
            for overlap in (False, True, True, False):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beta, it, _ = inner._run(SOLVE["lambda_"], SOLVE["rho"],
                                         SOLVE["tol"], SOLVE["max_iter"],
                                         overlap=overlap)
                torch.cuda.synchronize()
                loop_s[overlap].append(time.perf_counter() - t0)
                if not (it == ref_it and np.array_equal(
                        beta.double().cpu().numpy(), ref)):
                    raise AssertionError(f"{label} P={P} overlap={overlap}: "
                                         "disagrees with the single device")
                if overlap:
                    add("fused_banded_sweep_sub", 3 * P * it)
                else:
                    add(whole, P * it)
            log(f"[mesh] {label} P={P} sweep loop alone: unsplit "
                f"{loop_s[False]} s, split (overlap=True) {loop_s[True]} s "
                f"(unsplit, split, split, unsplit), {ref_it} sweeps, beta "
                "bitwise the single device's in every run")
            del prob, inner
        del Y
        torch.cuda.empty_cache()

    coords, A = knn_graph(SPOTS, True)
    Y, X, _ = make_problem(SPOTS, TYPES, SKETCH, coords=coords)
    t0 = time.perf_counter()
    prob = prepare_sharded_bcd(Y, X, A, coords=coords, mesh=card_mesh(2))
    torch.cuda.synchronize()
    plan = prob._inner.plan
    log(f"[mesh] 1M irregular on 2 shards: prepare "
        f"{time.perf_counter() - t0:.3f} s, strategy {prob.strategy}, "
        f"{plan.shard_size} spots a shard, halo width {plan.halo_width}, "
        f"{plan.nbr_idx.shape[1]} neighbour slots")
    if prob.strategy != "halo":
        raise AssertionError("the 1M irregular problem did not take the "
                             "halo plan")
    ref, ref_it = REFERENCE["1M irregular"]
    info = timed_mesh_solve(prob, "1M irregular P=2 halo",
                            (ref, ref_it, False))
    add("coordinate_descent_block", 2 * 2 * info["n_iterations"])
    # Each shard's neighbour sums once a sweep and once for the objective.
    add("neighbor_sum", 2 * 2 * (info["n_iterations"] + 1))
    halo["prob"] = prob._inner
    del Y

    sweeps = phase_fit("262k grid on a 2-shard mesh",
                       grid_coords(side=FIT_SIDE), float(FIT_SIDE),
                       FIT_GENES, runs=("once",), counts=grid_fit_counts,
                       model_kw={"mesh": card_mesh(2)})
    add("fused_banded_sweep", 2 * sweeps)
    return want


def phase_halo_split(inner, reps: int = 5) -> None:
    """Where a halo-plan sweep's time goes, by CUDA events over ``reps``
    sweeps each: whole sweeps, the halo exchange and neighbour sums alone,
    and kernel #2 alone on those sums (per shard, on the shards'
    streams)."""
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.parallel import solver as psolver

    mesh = inner.mesh
    lam, rho = bcd.f32(SOLVE["lambda_"]), bcd.f32(SOLVE["rho"]
                                                  * inner.rho_scale)
    ops = dict(inner._ops)
    ops["inv_den"] = [bcd.gs_inv_den(x, n, lam) for x, n in
                      zip(ops["XtX"], ops["nnb"])]
    ops["gs"] = [bcd.gs_pass_fn(x, n, lam, rho) for x, n in
                 zip(ops["XtX"], ops["nnb"])]
    betas = inner._beta0(None)
    spares = [torch.empty_like(b) for b in betas]

    def neighbour_sums():
        pools = psolver._halo_exchange(mesh, betas, ops["send"])
        mesh.fork()
        out = []
        for s, beta in enumerate(betas):
            with mesh.on(s):
                out.append(psolver._shard_ns(beta, pools[mesh[s]],
                                             ops["nbr"][s]))
        mesh.gather([])
        return out

    ns = neighbour_sums()

    def kernels():
        mesh.fork()
        for s, beta in enumerate(betas):
            with mesh.on(s):
                bcd.coordinate_descent_block(
                    beta, ops["Xty_t"][s], ops["XtX"][s], ns[s],
                    ops["inv_den"][s], lam, rho, out=spares[s])
        mesh.gather([])

    fns = {"sweep": lambda: psolver._sharded_sweep(mesh, betas, spares, ops),
           "neighbour sums": neighbour_sums, "kernel #2": kernels}
    ms = {}
    with bcd.full_f32_matmul():
        for name, fn in fns.items():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            stop.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(stop) / reps
    log(f"[mesh] 1M irregular halo sweep on 2 shards, ms per sweep (CUDA "
        f"events, {reps} sweeps each): {ms}")


# -- the multi-process mesh: two processes on the one card --------------------

def timed(fn):
    """``(seconds, fn())``, on the host clock ending in
    ``torch.cuda.synchronize()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def sweep_time(run, tag: str) -> dict:
    """The time of a sweep from ``run(n)``, which runs ``n`` sweeps (tol
    0, so it runs them all) and whatever else it does once: runs of
    ``SWEEP_RUNS`` sweeps in turns; the difference of the medians of the
    long and the short runs over the sweeps between them (the rest
    cancels), and its spread, the least and the most of the same
    difference taken over each turn's pair of runs."""
    short, long = min(SWEEP_RUNS), max(SWEEP_RUNS)
    runs = {short: [], long: []}
    for n in SWEEP_RUNS:
        runs[n].append(timed(lambda: run(n))[0])
    per = 1e3 / (long - short)
    ms = per * (np.median(runs[long]) - np.median(runs[short]))
    pairs = [per * (b - a) for a, b in zip(runs[short], runs[long])]
    log(f"[multihost] {tag}: runs of {short} / {long} sweeps, medians "
        f"{np.median(runs[short]):.4f} / {np.median(runs[long]):.4f} s "
        f"(ranges {min(runs[short]):.4f}-{max(runs[short]):.4f} / "
        f"{min(runs[long]):.4f}-{max(runs[long]):.4f} s): {ms:.3f} ms a "
        f"sweep, {min(pairs):.3f} to {max(pairs):.3f} ms over the "
        f"{len(pairs)} pairs")
    return {"sweep_ms": ms, "pair_ms": [min(pairs), max(pairs)],
            "runs": {str(n): t for n, t in runs.items()}}


def timed_runs(prob, strategy: str, tag: str, overlaps=()) -> dict:
    """A cold ``solve()`` of a prepared sharded problem (its ``beta`` and
    ``info`` are the result), then :func:`sweep_time` of ``solve()`` for
    the halo plan; for the banded mesh, of its sweep loop alone (``_run``:
    the sweeps and one gather of beta on the device, no objective and no
    fetch to the host) with each overlap in ``overlaps`` ("auto" splits
    across processes)."""
    cold, (beta, info) = timed(lambda: prob.solve(**SOLVE))
    log(f"[multihost] {tag}: cold solve {cold:.4f} s, "
        f"{info['n_iterations']} sweeps")
    out = {"beta": beta, "info": info, "cold": cold}
    lam, rho = SOLVE["lambda_"], SOLVE["rho"]
    if strategy == "halo":
        out["solve"] = sweep_time(lambda n: prob.solve(
            **{**SOLVE, "max_iter": n, "tol": 0.0}), f"{tag}, solve()")
    for overlap in overlaps:
        out[f"loop_{overlap}"] = sweep_time(
            lambda n: prob._inner._run(lam, rho, 0.0, n, overlap=overlap),
            f"{tag}, sweep loop (overlap={overlap})")
    return out


@functools.lru_cache(maxsize=1)
def job_operands():
    """The operands of a multi-process job: the 1M grid's (xty, X,
    coords, yty, A) and the 262k grid fit's (CSR counts, X, coords)."""
    from flashdeconv_tpu_torch.core.solver import sanitize_yty
    from flashdeconv_tpu_torch.utils import grid_coords

    coords, A = knn_graph(SPOTS, False)
    Y, X, _ = make_problem(SPOTS, TYPES, SKETCH)
    xty, yty = Y @ X.T, sanitize_yty(None, Y)
    del Y
    counts, Xc, _ = grid_fit_counts()
    return (xty, X, coords, yty, A), (counts, Xc, grid_coords(side=FIT_SIDE))


def multihost_operands(workdir: Path):
    """A job's operands, as the parent wrote them (:func:`write_job`),
    the counts memory-mapped."""
    from scipy import sparse

    ld = functools.partial(np.load, mmap_mode="r")
    grid = [np.load(workdir / f"{k}.npy") for k in ("xty", "X", "coords")]
    A = sparse.csr_matrix(
        tuple(np.load(workdir / f"A_{k}.npy")
              for k in ("data", "indices", "indptr")),
        shape=(grid[0].shape[0],) * 2)
    counts = tuple(ld(workdir / f"Y_{k}.npy")
                   for k in ("data", "indices", "indptr"))
    fit = (counts, np.load(workdir / "Y_X.npy"),
           np.load(workdir / "Y_coords.npy"))
    return (*grid, float(np.load(workdir / "yty.npy")), A), fit


def fit_rows(rank: int, world: int, n: int):
    """Rank ``rank``'s rows ``[lo, hi)`` of the job's fit: equal parts,
    the first cut 1,000 rows early so that the parts are uneven."""
    cuts = [r * n // world for r in range(world + 1)]
    cuts[1] -= 1000
    return cuts[rank], cuts[rank + 1]


def multihost_child(rank: int, world: int, port: int, workdir: str,
                    backend: str) -> None:
    """One process of a multi-process job (``--multihost-child``): joins a
    ``backend`` group of ``world`` processes on ``localhost:port`` (Gloo:
    every rank on ``cuda:0``; NCCL: rank r on ``cuda:r``, the card
    ``initialize`` makes current), takes one shard of ``global_spot_mesh``
    there, runs the 1M grid's banded mesh and halo plan and
    ``fit_distributed`` on its rows of the 262k counts, and writes its
    beta, times, peak memory and launches under ``workdir``."""
    import torch.distributed as dist
    from scipy import sparse

    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.ops import _build, bcd
    from flashdeconv_tpu_torch.parallel import multihost, prepare_sharded_bcd

    workdir = Path(workdir)
    for name in _build.build():  # the parent built them: this loads
        _build.load(name)
    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    (xty, X, coords, yty, A), ((data, indices, indptr), Xc, fit_coords) = (
        multihost_operands(workdir))
    card = torch.device("cuda", rank if backend == "nccl" else 0)
    mesh = multihost.global_spot_mesh(1, device="cuda" if backend == "nccl"
                                      else card)
    if not (mesh.spans_processes and mesh.main == card
            and mesh.local == (rank,) and torch.cuda.current_device()
            == (card.index if backend == "nccl" else 0)):
        raise AssertionError(f"rank {rank}: not a mesh across processes on "
                             f"{card}: {mesh}")
    torch.cuda.reset_peak_memory_stats(card)
    record = {}
    for strategy in ("banded", "halo"):
        t0 = time.perf_counter()
        prob = prepare_sharded_bcd(None, X, A, coords=coords, mesh=mesh,
                                   xty=xty, yty=yty, strategy=strategy)
        torch.cuda.synchronize()
        prep = time.perf_counter() - t0
        if strategy == "banded" and not prob._inner.use_fused:
            raise AssertionError("the banded mesh is not the fused one")
        runs = timed_runs(prob, strategy, f"p{rank} 1M grid {strategy}, "
                          f"prepare {prep:.3f} s",
                          ("auto",) if strategy == "banded" else ())
        np.save(workdir / f"beta_{strategy}_p{rank}.npy", runs.pop("beta"))
        record[strategy] = {"prepare_s": prep, "sweeps": runs.pop(
            "info")["n_iterations"], **runs}
        del prob

    # The fit on this process's rows, split at an uneven row.
    lo, hi = fit_rows(rank, world, indptr.shape[0] - 1)
    a, b = int(indptr[lo]), int(indptr[hi])
    Y_local = sparse.csr_matrix(
        (np.asarray(data[a:b]), np.asarray(indices[a:b]),
         np.asarray(indptr[lo:hi + 1]) - a), shape=(hi - lo, Xc.shape[1]))
    model = FlashDeconv(sketch_dim=SKETCH, device=card)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit_distributed(Y_local, Xc, fit_coords[lo:hi])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    np.save(workdir / f"beta_fit_p{rank}.npy", model.beta_)
    record["fit"] = {"rows": list(model.host_rows_), "seconds": fit_s,
                     "sweeps": model.info_["n_iterations"],
                     "lambda": model.lambda_used_,
                     "stages": model.timings_}
    record["peak_bytes"] = torch.cuda.max_memory_allocated(card)
    log(f"[multihost] p{rank} fit_distributed rows [{lo}, {hi}): "
        f"{fit_s:.3f} s, {model.info_['n_iterations']} sweeps, stages "
        + ", ".join(f"{k} {v:.3f} s" for k, v in model.timings_.items()))
    fb, cd, ns = (bcd.fused_banded_sweep, bcd.coordinate_descent_block,
                  bcd.neighbor_sum)
    record["launches"] = {
        "fused_banded_sweep_sub": fb.sub_launches,
        "fused_banded_sweep": fb.launches,
        "coordinate_descent_block": cd.launches,
        "neighbor_sum": ns.launches,
    }
    record["card_launches"] = {
        "fused_banded_sweep": dict(fb.card_launches),
        "coordinate_descent_block": dict(cd.card_launches),
        "neighbor_sum": dict(ns.card_launches)}
    # Every sweep of a split mesh (the banded mesh across processes) is 3
    # sub-range calls a shard; the halo plan's one kernel #2 call and one
    # neighbour-sum call a shard, and one more a solve for the objective.
    timed_sweeps = sum(SWEEP_RUNS)
    want = {"fused_banded_sweep_sub": 3 * (record["banded"]["sweeps"]
                                           + timed_sweeps
                                           + record["fit"]["sweeps"]),
            "fused_banded_sweep": 0,
            "coordinate_descent_block": record["halo"]["sweeps"]
            + timed_sweeps,
            "neighbor_sum": record["halo"]["sweeps"] + 1 + timed_sweeps
            + len(SWEEP_RUNS)}
    if record["launches"] != want or any(
            set(fn.card_launches) != {card.index} for fn in (fb, cd, ns)):
        raise AssertionError(f"rank {rank}: launches {record['launches']} "
                             f"on cards {record['card_launches']}, expected "
                             f"{want} on {card}")
    (workdir / f"record_p{rank}.json").write_text(json.dumps(record))
    dist.destroy_process_group()


def job_refs(P: int, ops, add, overlaps=()):
    """One process's ``P``-shard mesh on ``cuda:0``, the reference of a
    job of ``P`` processes: the banded mesh and the halo plan of the 1M
    grid through :func:`timed_runs` (the banded mesh's loop timed with
    each of ``overlaps``) and the 262k fit. ``add(kernel, n)`` collects
    the launches. Returns ``(refs, fit)``, kept in ``JOB_REFS`` for the
    next job of ``P`` processes (which then launches nothing here)."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd

    if P in JOB_REFS:
        return JOB_REFS[P]
    (xty, X, coords, yty, A), (counts, Xc, fit_coords) = ops
    refs = {}
    for strategy in ("banded", "halo"):
        prob = prepare_sharded_bcd(None, X, A, coords=coords,
                                   mesh=card_mesh(P), xty=xty, yty=yty,
                                   strategy=strategy)
        refs[strategy] = timed_runs(
            prob, strategy, f"1 process, {P} shards, 1M grid {strategy}",
            overlaps if strategy == "banded" else ())
        del prob
    add("fused_banded_sweep", P * refs["banded"]["info"]["n_iterations"])
    for overlap in overlaps:
        add("fused_banded_sweep_sub" if overlap else "fused_banded_sweep",
            (3 if overlap else 1) * P * sum(SWEEP_RUNS))
    add("coordinate_descent_block", P * (
        refs["halo"]["info"]["n_iterations"] + sum(SWEEP_RUNS)))
    add("neighbor_sum", P * (refs["halo"]["info"]["n_iterations"] + 1
                             + sum(SWEEP_RUNS) + len(SWEEP_RUNS)))
    fit = FlashDeconv(sketch_dim=SKETCH, mesh=card_mesh(P),
                      device_outputs=False).fit(counts, Xc, fit_coords)
    add("fused_banded_sweep", P * fit.info_["n_iterations"])
    torch.cuda.empty_cache()
    JOB_REFS[P] = refs, fit
    return refs, fit


def run_job(ops, refs, ref_fit, backend: str, world: int) -> list:
    """A job of ``world`` processes of this script (``--multihost-child``)
    over ``backend``, on ``ops`` written to a temporary directory; each
    process's banded mesh, halo plan and fit must be bitwise ``refs`` /
    ``ref_fit`` (:func:`job_refs` of ``world`` shards). A process that
    fails or outlasts ``MULTIHOST_TIMEOUT`` fails the run. Returns the
    processes' records."""
    tag = "multihost" if backend == "gloo" else "multicard"
    (xty, X, coords, yty, A), (counts, Xc, fit_coords) = ops
    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        t0 = time.perf_counter()
        for name, arr in (("xty", xty), ("X", X), ("coords", coords),
                          ("yty", np.asarray(yty)), ("A_data", A.data),
                          ("A_indices", A.indices), ("A_indptr", A.indptr),
                          ("Y_data", counts.data),
                          ("Y_indices", counts.indices),
                          ("Y_indptr", counts.indptr), ("Y_X", Xc),
                          ("Y_coords", fit_coords)):
            np.save(workdir / f"{name}.npy", arr)
        where = ("cuda:0 over Gloo (NCCL refuses two ranks on one card, "
                 "'Duplicate GPU detected')" if backend == "gloo" else
                 f"cuda:0-{world - 1} over NCCL, one card a process")
        log(f"[{tag}] operands written in {time.perf_counter() - t0:.1f} "
            f"s; {world} processes on {where}")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        logs = [open(workdir / f"log_p{r}.txt", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--multihost-child", str(r), str(world), str(port),
             str(workdir), backend], stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        try:
            deadline = time.perf_counter() + MULTIHOST_TIMEOUT
            while any(p.poll() is None for p in procs):
                failed = [p for p in procs if p.poll() not in (None, 0)]
                if failed or time.perf_counter() > deadline:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        job_s = time.perf_counter() - t0
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[{tag} p{r}] {line}")
            f.close()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError(
                f"[{tag}] the {backend} job failed: return codes "
                f"{[p.returncode for p in procs]} after {job_s:.1f} s")
        records = [json.loads((workdir / f"record_p{r}.json").read_text())
                   for r in range(world)]
        for r, rec in enumerate(records):
            for strategy in ("banded", "halo"):
                beta = np.load(workdir / f"beta_{strategy}_p{r}.npy")
                ref = refs[strategy]
                if not (rec[strategy]["sweeps"]
                        == ref["info"]["n_iterations"]
                        and np.array_equal(beta, ref["beta"])):
                    raise AssertionError(
                        f"[{tag}] p{r} {strategy}: not bitwise the "
                        f"single-process {world}-shard mesh")
            beta = np.load(workdir / f"beta_fit_p{r}.npy")
            if not (rec["fit"]["rows"] == list(fit_rows(r, world,
                                                        FIT_SIDE ** 2))
                    and rec["fit"]["sweeps"] == ref_fit.info_["n_iterations"]
                    and rec["fit"]["lambda"] == ref_fit.lambda_used_
                    and np.array_equal(beta, ref_fit.beta_)):
                raise AssertionError(
                    f"[{tag}] p{r} fit_distributed: not bitwise the "
                    f"single-process fit on the {world}-shard mesh")
    launches = {key: sum(rec["launches"][key] for rec in records)
                for key in records[0]["launches"]}
    for strategy, key in (("banded", "loop_auto"), ("halo", "solve")):
        ms = [(rec[strategy][key]["sweep_ms"], rec[strategy][key]["pair_ms"])
              for rec in records]
        ref = refs[strategy]
        log(f"[{tag}] 1M grid {strategy}: {world} {backend} processes cold "
            f"solve {[rec[strategy]['cold'] for rec in records]} s, (ms a "
            f"sweep, [its spread]) {ms}, against 1 process {world} shards "
            f"{ref['cold']:.4f} s, "
            + ", ".join(f"{k} {v['sweep_ms']:.3f} {v['pair_ms']}"
                        for k, v in ref.items() if k.startswith(
                            ("loop_", "solve")))
            + f" ms a sweep ({ref['info']['n_iterations']} sweeps); beta "
            "bitwise in every process")
    log(f"[{tag}] 262k fit: {world} {backend} processes "
        f"{[rec['fit']['seconds'] for rec in records]} s, 1 process "
        f"{sum(ref_fit.timings_.values()):.3f} s of stages, "
        f"{ref_fit.info_['n_iterations']} sweeps, beta bitwise; the job "
        f"{job_s:.1f} s; peak bytes a process "
        f"{[rec['peak_bytes'] for rec in records]}; launches in the job "
        f"{launches}, by process and card "
        f"{[rec['card_launches'] for rec in records]}")
    return records


def phase_multihost(children: dict) -> dict:
    """The multi-process main path (see the module docstring, item 5a).
    Leaves the job's launches in ``children``; returns the launches this
    process's single-process references must show."""
    t_phase = time.perf_counter()
    want = {}

    def add(name, n):
        want[name] = want.get(name, 0) + n

    ops = job_operands()
    # The banded mesh's loop unsplit (what "auto" picks for one process's
    # shards of 500k spots) and split, as across processes.
    refs, ref_fit = job_refs(PROCESSES, ops, add, (False, True))
    records = run_job(ops, refs, ref_fit, "gloo", PROCESSES)
    for key in records[0]["launches"]:
        children[key] = sum(rec["launches"][key] for rec in records)
    log(f"[multihost] the phase {time.perf_counter() - t_phase:.1f} s")
    return want


# -- several cards: one process's mesh, and NCCL with one card a process ------

def cards(n: int):
    """A mesh of the first ``n`` cards, one shard each."""
    return tuple(torch.device("cuda", i) for i in range(n))


def card_peaks(n: int) -> list:
    """Each of the first ``n`` cards' peak allocated bytes since its last
    reset."""
    return [torch.cuda.max_memory_allocated(i) for i in range(n)]


def loop_beta(prob, overlap: bool):
    """The banded mesh's sweep loop alone, ``MULTICARD_SWEEPS`` sweeps
    (tol 0) from the uniform start: (beta on the host, sweeps)."""
    beta, it, _ = prob._inner._run(SOLVE["lambda_"], SOLVE["rho"], 0.0,
                                   MULTICARD_SWEEPS, overlap=overlap)
    return beta.cpu().numpy(), it


def phase_multicard(children: dict) -> dict:
    """The multi-card path (see the module docstring, item 5b): needs two
    cards or more. Leaves the NCCL jobs' launches in ``children``; returns
    the launches this process must show."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.core.solver import prepare_bcd, sanitize_yty
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.ops import countsketch as cs
    from flashdeconv_tpu_torch.parallel import prepare_sharded_bcd

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    widths = (2, 4) if n_cards >= 4 else (2,)
    for line in subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines():
        log(f"[multicard] card {line}")
    first, last = torch.device("cuda", 0), torch.device("cuda", n_cards - 1)
    kernels = (bcd.fused_banded_sweep, bcd.coordinate_descent_block,
               cs.countsketch_project_kernel, bcd.neighbor_sum)
    for fn in kernels:
        fn.card_launches.clear()
    want = {}

    def add(name, n):
        want[name] = want.get(name, 0) + n

    def current_is_first(label):
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"[multicard] {label}: cuda:0 is no longer "
                                 "the current card")

    # Single-device solves on the last card while cuda:0 is current, each
    # bitwise the same solve on cuda:0; the grid's launch the objective
    # kernel once a solve.
    for label, irregular, kernel in (
            ("1M grid", False, "fused_banded_sweep"),
            ("1M irregular", True, "coordinate_descent_block")):
        coords, A = knn_graph(SPOTS, irregular)
        Y, X, _ = make_problem(SPOTS, TYPES, SKETCH,
                               coords=coords if irregular else None)
        if label not in REFERENCE:
            prob = prepare_bcd(Y, X, A, coords=coords, device=first)
            beta, info = prob.solve(**SOLVE)
            REFERENCE[label] = (beta, info["n_iterations"])
            add(kernel, info["n_iterations"])
            add("fused_banded_objective", int(not irregular))
            add("neighbor_sum", neighbor_sum_calls(prob)
                * (info["n_iterations"] + 1))
            del prob
        ref, ref_it = REFERENCE[label]
        current_is_first(label)
        t0 = time.perf_counter()
        prob = prepare_bcd(Y, X, A, coords=coords, device=last)
        prep = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(last)
        dt, (beta, info) = timed(lambda: prob.solve(**SOLVE))
        current_is_first(label)
        add(kernel, info["n_iterations"])
        add("fused_banded_objective", int(not irregular))
        add("neighbor_sum", neighbor_sum_calls(prob)
            * (info["n_iterations"] + 1))
        log(f"[multicard] {label} on {last} with cuda:0 current: prepare "
            f"{prep:.3f} s, solve {dt:.4f} s, {info['n_iterations']} sweeps "
            f"(cuda:0 {ref_it}), tier {type(prob.tier).__name__}, peak "
            f"{torch.cuda.max_memory_allocated(last)} B on {last}")
        if not (info["n_iterations"] == ref_it
                and np.array_equal(beta, ref)):
            raise AssertionError(f"[multicard] {label} on {last}: not "
                                 "bitwise the solve on cuda:0")
        del prob, Y
    Y, buckets, weights, _ = cs_operands(CELLS, DENSE_GENES, SKETCH)
    sketches = [cs.countsketch_project_kernel(
        Y.to(d), buckets.to(d), weights.to(d), SKETCH) for d in (first, last)]
    add("countsketch_project", 2)
    current_is_first("sketch")
    if not torch.equal(sketches[0], sketches[1].to(first)):
        raise AssertionError(f"[multicard] the dense sketch on {last} is not "
                             "bitwise cuda:0's")
    log(f"[multicard] dense sketch {tuple(Y.shape)} -> {SKETCH} on {last} "
        "with cuda:0 current: bitwise cuda:0's")
    del Y, sketches
    torch.cuda.empty_cache()

    # The banded mesh on P cards against one card's P shards: the sweep
    # loop alone, MULTICARD_SWEEPS sweeps, bitwise; at K = 20 also timed.
    ops = job_operands()
    (xty, X, coords, yty, A), (counts, Xc, fit_coords) = ops
    lam, rho = SOLVE["lambda_"], SOLVE["rho"]
    rates = {}

    def loop_timing(prob, overlap, tag, P):
        ms = sweep_time(lambda n: prob._inner._run(lam, rho, 0.0, n,
                                                   overlap=overlap),
                        f"{tag}, sweep loop (overlap={overlap})")["sweep_ms"]
        add("fused_banded_sweep_sub" if overlap else "fused_banded_sweep",
            (3 if overlap else 1) * P * sum(SWEEP_RUNS))
        rates[(tag, overlap)] = SPOTS / (ms * 1e-3)
        return ms

    def host_profile(prob, tag, P):
        """Where the host's time goes in 22 sweeps of the loop (unsplit):
        ``torch.profiler``'s rows by self CPU time."""
        from torch.profiler import ProfilerActivity, profile

        prob._inner._run(lam, rho, 0.0, 2)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prob._inner._run(lam, rho, 0.0, 22)
            torch.cuda.synchronize()
        add("fused_banded_sweep", P * 24)
        log(f"[multicard] {tag}, 22 sweeps of the loop under torch.profiler"
            ":\n" + prof.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=12))

    one = prepare_sharded_bcd(None, X, A, coords=coords, mesh=card_mesh(1),
                              xty=xty, yty=yty, strategy="banded")
    loop_timing(one, False, "1 card 1 shard", 1)
    del one
    for K, Ps in ((TYPES, widths), (128, (2,))):
        if K != TYPES:
            Yk, Xk, _ = make_problem(SPOTS, K, SKETCH)
            xk, yk = Yk @ Xk.T, sanitize_yty(None, Yk)
            del Yk
        else:
            Xk, xk, yk = X, xty, yty
        whole = ("fused_banded_sweep_large_k"
                 if K > bcd.REGISTER_PASS_MAX_K else "fused_banded_sweep")
        for P in Ps:
            label = f"1M grid K={K}"
            probs = {}
            for where, mesh in (("1 card", card_mesh(P)),
                                (f"{P} cards", cards(P))):
                probs[where] = prepare_sharded_bcd(
                    None, Xk, A, coords=coords, mesh=mesh, xty=xk, yty=yk,
                    strategy="banded")
                if not probs[where]._inner.use_fused:
                    raise AssertionError(f"{label}: not the fused mesh")
            ref, ref_it = loop_beta(probs["1 card"], False)
            add(whole, P * ref_it)
            for i in range(P):
                torch.cuda.reset_peak_memory_stats(i)
            for overlap in (False, True):
                beta, it = loop_beta(probs[f"{P} cards"], overlap)
                add("fused_banded_sweep_sub" if overlap else whole,
                    (3 if overlap else 1) * P * it)
                if not (it == ref_it == MULTICARD_SWEEPS
                        and np.array_equal(beta, ref)):
                    raise AssertionError(
                        f"[multicard] {label} on {P} cards, overlap "
                        f"{overlap}: not bitwise one card's {P} shards "
                        f"after {it} sweeps")
            log(f"[multicard] {label} banded mesh on {P} cards, unsplit and "
                f"split: {MULTICARD_SWEEPS} sweeps each, bitwise one card's "
                f"{P}-shard mesh; peak bytes by card {card_peaks(P)}")
            if K == TYPES:
                ms = {"1 card": loop_timing(probs["1 card"], False,
                                            f"1 card {P} shards", P)}
                for overlap in (False, True):
                    ms[f"{P} cards overlap={overlap}"] = loop_timing(
                        probs[f"{P} cards"], overlap, f"{P} cards", P)
                if P == 2:
                    host_profile(probs["1 card"], "1 card 2 shards", P)
                    host_profile(probs["2 cards"], "2 cards", P)
                base = rates[("1 card 1 shard", False)]
                log(f"[multicard] 1M grid banded mesh, ms a sweep: {ms}; "
                    "spots/s: " + ", ".join(
                        f"{tag} overlap={o} {r:.1f} ({r / base:.3f} x one "
                        "card's 1 shard"
                        + (f", scaling efficiency {r / base / P:.3f})"
                           if tag.endswith("cards") else ")")
                        for (tag, o), r in rates.items()
                        if tag != "1 card 1 shard"))
                rates = {k: v for k, v in rates.items()
                         if k[0] == "1 card 1 shard"}
            del probs
            torch.cuda.empty_cache()

    # The halo plan of the 1M irregular problem on 2 cards.
    coords_i, A_i = knn_graph(SPOTS, True)
    Y, X_i, _ = make_problem(SPOTS, TYPES, SKETCH, coords=coords_i)
    halo = {}
    for where, mesh in (("1 card", card_mesh(2)), ("2 cards", cards(2))):
        prob = prepare_sharded_bcd(Y, X_i, A_i, coords=coords_i, mesh=mesh)
        if prob.strategy != "halo":
            raise AssertionError("the 1M irregular problem did not take the "
                                 "halo plan")
        for i in range(2):
            torch.cuda.reset_peak_memory_stats(i)
        beta, info = prob.solve(**SOLVE)
        add("coordinate_descent_block", 2 * info["n_iterations"])
        add("neighbor_sum", 2 * (info["n_iterations"] + 1))
        timing = sweep_time(lambda n: prob.solve(
            **{**SOLVE, "max_iter": n, "tol": 0.0}),
            f"1M irregular halo plan on {where}, solve()")
        add("coordinate_descent_block", 2 * sum(SWEEP_RUNS))
        add("neighbor_sum", 2 * (sum(SWEEP_RUNS) + len(SWEEP_RUNS)))
        halo[where] = (beta, info["n_iterations"], timing["sweep_ms"],
                       card_peaks(2))
        del prob
    if not (halo["2 cards"][1] == halo["1 card"][1]
            and np.array_equal(halo["2 cards"][0], halo["1 card"][0])):
        raise AssertionError("[multicard] the 1M irregular halo plan on 2 "
                             "cards is not bitwise one card's 2 shards")
    log(f"[multicard] 1M irregular halo plan on 2 cards: "
        f"{halo['2 cards'][1]} sweeps, bitwise one card's 2 shards; ms a "
        f"sweep {halo['2 cards'][2]:.3f} (one card 2 shards "
        f"{halo['1 card'][2]:.3f}); spots/s "
        f"{SPOTS / halo['2 cards'][2] * 1e3:.1f} (one card "
        f"{SPOTS / halo['1 card'][2] * 1e3:.1f}); peak bytes by card "
        f"{halo['2 cards'][3]} (one card's 2 shards {halo['1 card'][3]})")
    del Y, halo
    torch.cuda.empty_cache()

    # FlashDeconv(n_shards=2) on the first two cards, against one card's
    # 2-shard fit (the 2-process job's reference).
    a = job_refs(2, ops, add)[1]
    dt, b = timed(lambda: FlashDeconv(
        sketch_dim=SKETCH, device_outputs=False, n_shards=2).fit(
            counts, Xc, fit_coords))
    add("fused_banded_sweep", 2 * b.info_["n_iterations"])
    if not (a.info_["n_iterations"] == b.info_["n_iterations"]
            and a.lambda_used_ == b.lambda_used_
            and np.array_equal(a.beta_, b.beta_)):
        raise AssertionError("[multicard] FlashDeconv(n_shards=2).fit is "
                             "not bitwise one card's 2-shard fit")
    log(f"[multicard] 262k fit, FlashDeconv(n_shards=2) on 2 cards: "
        f"{dt:.3f} s, stages {sum(b.timings_.values()):.3f} s (one card's 2 "
        f"shards' stages {sum(a.timings_.values()):.3f} s), "
        f"{b.info_['n_iterations']} sweeps, beta bitwise")
    del a, b

    # NCCL, one card a process, against one process's mesh of as many
    # shards on cuda:0.
    for world in widths:
        refs, ref_fit = job_refs(world, ops, add)
        records = run_job(ops, refs, ref_fit, "nccl", world)
        for key in records[0]["launches"]:
            children[key] = children.get(key, 0) + sum(
                rec["launches"][key] for rec in records)
    log(f"[multicard] launches by card in this process: " + ", ".join(
        f"{fn.__name__} {dict(sorted(fn.card_launches.items()))}"
        for fn in kernels) + f"; in the NCCL jobs {children}")
    # Kernel #1 on every card of the meshes and on the last; #2 and the
    # neighbour sums on the halo plan's two and the last; #3 on cuda:0 and
    # the last. Each card's count adds up to the wrapper's.
    meshes = set(range(max(widths)))
    for fn, on in zip(kernels, (meshes | {n_cards - 1}, {0, 1, n_cards - 1},
                                {0, n_cards - 1}, {0, 1, n_cards - 1})):
        total = sum(getattr(fn, attr) for attr in (
            "launches", "large_k_launches", "sub_launches", "rest_launches")
            if hasattr(fn, attr))
        if set(fn.card_launches) != on or sum(
                fn.card_launches.values()) != total:
            raise AssertionError(
                f"[multicard] {fn.__name__} launched on cards "
                f"{dict(fn.card_launches)} ({total} in all), expected on "
                f"{sorted(on)}")
    log(f"[multicard] the phase {time.perf_counter() - t_phase:.1f} s on "
        f"{n_cards} cards")
    return want


# -- the XLA tier: f64 at any K, and K > 384 ------------------------------------

def xla_tier(prob, label: str) -> None:
    """``prob`` must lie on the card and have taken the XLA tier (no
    kernel takes its dtype or K)."""
    t = prob.tier
    if not (t.Xty_t.is_cuda and t.XtX.is_cuda and t.nnb.is_cuda):
        raise AssertionError(f"{label}: operands are not on the card")
    if t.uses_kernel or type(t).__name__ == "FusedBandedTier":
        raise AssertionError(f"{label}: a kernel's tier took the problem")
    log(f"[xla tier] {label}: {type(t).__name__}, {prob.n_spots} spots, "
        f"K={prob.n_types}, {t.Xty_t.dtype}")


def timed_solves(prob, label: str, **solve) -> dict:
    """A cold ``solve()``, then warm ``solve()`` and
    ``solve(return_device=True)``, each ended by a synchronize and timed
    by the host clock, with the peak memory; the device beta must be the
    host one, in the solve dtype. Returns the last info."""
    runs = {}
    for name, ret in (("cold solve()", False), ("warm solve()", False),
                      ("warm solve(return_device=True)", True)):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beta, info = prob.solve(return_device=ret, **solve)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[name] = beta
        log(f"[{label}] {name}: {dt:.4f} s, {info['n_iterations']} sweeps "
            f"({dt / info['n_iterations'] * 1e3:.3f} ms a sweep, the fetch "
            f"included where there is one), converged {info['converged']}, "
            f"objective {info['final_objective']:.9g}, peak "
            f"{torch.cuda.max_memory_allocated()} B allocated")
    dev = runs["warm solve(return_device=True)"]
    if not (dev.is_cuda and dev.dtype == prob.tier.Xty_t.dtype):
        raise AssertionError(f"{label}: return_device gave {dev.dtype} on "
                             f"{dev.device}")
    if not (np.array_equal(dev.cpu().double().numpy(), runs["warm solve()"])
            and np.array_equal(runs["cold solve()"], runs["warm solve()"])):
        raise AssertionError(f"{label}: the solves disagree")
    if not np.isfinite(runs["warm solve()"]).all():
        raise AssertionError(f"{label}: non-finite beta")
    return info


def card_vs_cpu(Y, X, A, coords, dtype, bound: float, label: str,
                check=xla_tier):
    """The same problem solved on the card and by the port on the CPU: the
    same sweeps and beta within ``bound`` of max|beta|; ``check(prob,
    label)`` vets the card's problem (by default: the XLA tier). Returns
    (the neighbour-sum launches of the card's solve, its sweeps)."""
    from flashdeconv_tpu_torch.core.solver import prepare_bcd

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        prob = prepare_bcd(Y, X, A, coords=coords, dtype=dtype, device=dev)
        if dev == "cuda":
            check(prob, f"{label} on the card")
            calls = neighbor_sum_calls(prob)
        beta, info = prob.solve(**SOLVE)
        out[dev] = (beta, info["n_iterations"], time.perf_counter() - t0)
    (bc, ic, tc), (bh, ih, th) = out["cuda"], out["cpu"]
    err = float(np.abs(bc - bh).max() / np.abs(bh).max())
    log(f"[{label}] card vs CPU: {ic} vs {ih} sweeps, max |beta_card - "
        f"beta_cpu| / max|beta_cpu| = {err:.3e} (bound {bound:g}); "
        f"prepare + solve {tc:.2f} s on the card, {th:.2f} s on the CPU")
    if ic != ih or not err <= bound:
        raise AssertionError(f"{label}: the card disagrees with the CPU")
    return calls * (ic + 1), ic


def phase_f64() -> dict:
    """The f64 solve on the card (see the module docstring, item 6).
    Returns {} (no kernel may launch)."""
    t_phase = time.perf_counter()
    coords, A = knn_graph(SPOTS, False)
    prob, prob_s = prepare_on(coords, A, TYPES, grid=True, dtype=np.float64)
    xla_tier(prob, "1M grid f64")
    log(f"[f64] 1M grid prepare {prob_s:.3f} s")
    timed_solves(prob, "f64", **SOLVE)
    del prob
    torch.cuda.empty_cache()
    from flashdeconv_tpu_torch.utils import build_knn_graph, grid_coords

    c262 = grid_coords(side=FIT_SIDE)
    Y, X, _ = make_problem(FIT_SIDE ** 2, TYPES, SKETCH)
    card_vs_cpu(Y, X, build_knn_graph(c262, k=6), c262, np.float64, 1e-12,
                "f64")
    phase_fit("262k grid f64", c262, float(FIT_SIDE), FIT_GENES,
              runs=("once",), counts=grid_fit_counts,
              model_kw={"solver_dtype": np.float64})
    log(f"[f64] phase {time.perf_counter() - t_phase:.1f} s")
    return {}


def kernel_tier(tier_name: str):
    """A ``card_vs_cpu`` check: the card's problem took ``tier_name`` and
    its sweeps launch a kernel."""
    def check(prob, label: str) -> None:
        t = prob.tier
        if type(t).__name__ != tier_name or not t.uses_kernel:
            raise AssertionError(f"{label}: took the {type(t).__name__}, "
                                 f"uses_kernel {t.uses_kernel}")
        log(f"[large K] {label}: {tier_name}, {prob.n_spots} spots, "
            f"K={prob.n_types}, a kernel's sweeps")
    return check


def atlas_grid():
    """The 1M grid at K = 338, prepared on the card; it must take the
    fused tier, whose sweeps launch kernel #1. Returns (problem, prepare
    seconds)."""
    coords, A = knn_graph(SPOTS, False)
    prob, prob_s = prepare_on(coords, A, ATLAS_TYPES, grid=True)
    if not (prob.use_fused_banded and prob.tier.uses_kernel):
        raise AssertionError(f"the 1M grid at K = {ATLAS_TYPES} did not "
                             "take the fused tier")
    log(f"[large K] 1000x1000 K={ATLAS_TYPES}: FusedBandedTier, prepare "
        f"{prob_s:.3f} s; (K, N) f32 buffer {4 * ATLAS_TYPES * SPOTS} B")
    return prob, prob_s


def phase_atlas_k(grid) -> dict:
    """K = 338 on the card and the XLA tier at K = 385 (see the module
    docstring, item 7); ``grid`` is :func:`atlas_grid`'s problem. Returns
    the launches the path must show: kernel #1's tile pass (its one-block
    instances, counted as wide too) for each sweep of the grid's three
    solves, kernel #2a's for each sweep of the 4,096-spot gather solve and
    fit, and the neighbour-sum kernel's (any K) for each f32 gather-tier
    solve; none at K = 385."""
    from flashdeconv_tpu_torch import FlashDeconv
    from flashdeconv_tpu_torch.core import deconv
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.utils import build_knn_graph, grid_coords

    t_phase = time.perf_counter()
    info = timed_solves(grid, "large K", **SOLVE)
    grid_sweeps = 3 * info["n_iterations"]
    if not info["converged"]:
        raise AssertionError(f"the 1M grid at K = {ATLAS_TYPES} did not "
                             "converge")

    # The XLA tier above the kernels' K, on a grid small enough for the
    # run's limit.
    c262 = grid_coords(side=FIT_SIDE)
    xprob, xprob_s = prepare_on(c262, build_knn_graph(c262, k=6),
                                bcd.KERNEL_MAX_K + 1, grid=True)
    xla_tier(xprob, f"262k grid K={bcd.KERNEL_MAX_K + 1}")
    log(f"[large K] 262k grid K={bcd.KERNEL_MAX_K + 1} prepare "
        f"{xprob_s:.3f} s")
    info = timed_solves(xprob, "xla K", **dict(SOLVE, max_iter=XLA_CAP))
    ns = 3 * neighbor_sum_calls(xprob) * (info["n_iterations"] + 1)
    log(f"[large K] 262k grid K={bcd.KERNEL_MAX_K + 1}: "
        + ("converged" if info["converged"] else
           f"capped at max_iter={XLA_CAP} sweeps (rel "
           f"{info['final_change']:.3e} > tol {SOLVE['tol']})"))
    del xprob
    torch.cuda.empty_cache()

    c4k = irregular_coords(4096)
    A4k = build_knn_graph(c4k, k=6)
    Y, X, _ = make_problem(4096, ATLAS_TYPES, SKETCH, coords=c4k)
    calls, gather_sweeps = card_vs_cpu(Y, X, A4k, c4k, np.float32, 1e-5,
                                       "large K", check=kernel_tier(
                                           "GatherTier"))
    ns += calls

    Yc, Xc, truth = synthetic_counts(c4k, 64.0, FIT_GENES, ATLAS_TYPES,
                                     width=0.1, depth=6000.0)
    wire = []
    fetch = deconv.fetch_to_host

    def spy(t, *a, **k):
        wire.append(t.dtype)
        return fetch(t, *a, **k)

    deconv.fetch_to_host = spy
    try:
        model = FlashDeconv(sketch_dim=SKETCH, n_hvg=FIT_GENES,
                            outputs=("proportions", "dominant"))
        model.fit(Yc, Xc, c4k)
    finally:
        deconv.fetch_to_host = fetch
    agree = np.array_equal(model.dominant_,
                           np.argmax(model.proportions_, axis=1))
    log(f"[large K] 4096-cell K={ATLAS_TYPES} fit: dominant fetched as "
        f"{[str(d) for d in wire]}, equal to the host argmax {agree}, "
        f"{model.info_['n_iterations']} sweeps")
    if torch.int32 not in wire or torch.uint8 in wire or not agree:
        raise AssertionError("the K = 338 dominant is not int32 or "
                             "disagrees with the host argmax")
    # The fit's 4,096 cells take the gather tier, with no degree cap.
    ns += model.info_["n_iterations"] + 1
    gather_sweeps += model.info_["n_iterations"]
    log(f"[large K] phase {time.perf_counter() - t_phase:.1f} s")
    return {"fused_banded_sweep_large_k": grid_sweeps,
            "fused_banded_sweep_wide": grid_sweeps,
            "coordinate_descent_block_large_k": gather_sweeps,
            "coordinate_descent_block_wide": gather_sweeps,
            "neighbor_sum": ns}


# -- the panel kernels alone (--large-k) -----------------------------------------

def ptxas_entries(log_text: str) -> dict:
    """ptxas's report in a build log: {entry function: its "Used ...
    registers" and spill lines, joined}."""
    entries, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("registers" in line or "spill" in line):
            entries[entry] = (entries.get(entry, "") + " "
                              + line.replace("ptxas info    :", "").strip())
    return entries


def pass_instance(entry: str, small: bool) -> bool:
    """Whether a ``__global__`` instance is one a mode is about: with
    ``small`` (``--small-k``) every register sweep kernel, the spot-panel
    ones and the panel ones of TM <= 2, else (``--large-k``) the panel ones
    of TM >= 3."""
    tm = re.search(r"panel_kernelILi(\d+)E", entry)
    if tm:
        return (int(tm.group(1)) <= 2) == small
    return small and re.search(r"sweep_kernelILi|panel_kernel_spotI",
                               entry) is not None


def pass_report(small: bool) -> None:
    """ptxas's report (registers, spills) of the instances a mode is about
    (:func:`pass_instance`), then the blocks an SM holds at each K: with
    ``small`` each K's form at K = 1-64; else the panel pass's shared
    memory and blocks an SM at K = 65-384."""
    from flashdeconv_tpu_torch.ops import _build, bcd

    tag = "[small-k]" if small else "[large-k]"
    for name, so in _build.build().items():
        for entry, report in ptxas_entries(
                so.with_suffix(".log").read_text()).items():
            if pass_instance(entry, small):
                log(f"{tag} ptxas {entry}:{report}")
    fused, cd = _build.load("fused_banded_sweep"), _build.load("cd_block_sweep")
    for K in ((1, 6, 8, 9, 16, 17, 20, 24, 25, 32, 33, 34, 48, 54, 55, 64)
              if small else (65, 80, 96, 128, 129, 160, 192, 255, 256, 257,
                             288, 300, 320, 338, 352, 384)):
        if K <= bcd.REGISTER_PASS_MAX_K:
            log(f"{tag} K={K}: register pass, KMAX = {(K + 7) // 8 * 8}; "
                f"blocks an SM: fused "
                f"{fused.fdt_fused_banded_sweep_register_occupancy(K, 0)}, "
                f"fused with ns_rest "
                f"{fused.fdt_fused_banded_sweep_register_occupancy(K, 1)}, cd "
                f"{cd.fdt_cd_block_sweep_register_occupancy(K)}")
            continue
        if K <= bcd.SPOT_PANEL_MAX_K:
            log(f"{tag} K={K}: kernel #1 spot-panel pass, shared memory "
                f"{fused.fdt_spot_panel_pass_smem_bytes(K)} B, blocks an SM "
                f"{fused.fdt_fused_banded_sweep_panel_occupancy(K, 0)}, with "
                f"ns_rest {fused.fdt_fused_banded_sweep_panel_occupancy(K, 1)}"
                f"; kernel #2 panel pass, TM = {(K + 31) // 32} rows a "
                f"thread, shared memory {cd.fdt_panel_pass_smem_bytes(K)} B, "
                f"blocks an SM {cd.fdt_cd_block_sweep_panel_occupancy(K)}")
            continue
        log(f"{tag} K={K}: panel pass, TM = {(K + 31) // 32} rows a thread; "
            f"pass shared memory {fused.fdt_panel_pass_smem_bytes(K)} B; "
            f"blocks an SM: fused "
            f"{fused.fdt_fused_banded_sweep_panel_occupancy(K, 0)}, fused "
            f"with ns_rest {fused.fdt_fused_banded_sweep_panel_occupancy(K, 1)}"
            f", cd {cd.fdt_cd_block_sweep_panel_occupancy(K)}")


def build_against(root: str) -> dict:
    """The two sweep kernels built by ``nvcc`` from the sources of the
    checkout at ``root``, into that checkout's build directory, loaded and
    declared like this checkout's: {kernel name: ctypes library}."""
    from flashdeconv_tpu_torch.ops import _build

    ops = Path(root).resolve() / "flashdeconv_tpu_torch" / "ops"
    out = ops / "build"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    names = ("fused_banded_sweep", "cd_block_sweep")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for fut in [pool.submit(_build._compile, nvcc, ops / "csrc" / f"{n}.cu",
                                out / f"{n}-against.so") for n in names]:
            fut.result()
    libs = {}
    for n in names:
        libs[n] = ctypes.CDLL(str(out / f"{n}-against.so"))
        try:
            _build._declare(n, libs[n])
        except AttributeError as missing:
            # Sources older than the objective or the neighbour-sum
            # kernel: the sweep entries, declared before them, are all
            # that is timed here.
            log(f"[against] {root} {n}: {missing}")
        for entry, report in ptxas_entries(
                (out / f"{n}-against.log").read_text()).items():
            log(f"[against] {root} ptxas {entry}:{report}")
    log(f"[against] {root}: {len(names)} kernels built in "
        f"{time.perf_counter() - t0:.3f} s")
    return libs


def phase_against(prob, name: str, other: dict, label: str,
                  form: str = "whole") -> None:
    """Kernel ``name`` of this checkout and of ``other`` on the same
    operands (those of :func:`phase_fused_kernel` / :func:`phase_cd_kernel`,
    and for kernel #1's ``form`` "rest" those of :func:`phase_rest_kernel`,
    for "sub" the interior call of :func:`phase_sub_kernel` into a full
    carry), both through this checkout's launch code: max |Δ| between
    them, whether the bits are equal, and CUDA-event times in turns
    theirs, ours, ours, theirs."""
    from flashdeconv_tpu_torch.ops import _build, bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    inv = bcd.gs_inv_den(t.XtX, t.nnb, lam).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    if name == "fused_banded_sweep":
        x = bcd.to_fused_carry(seeded_beta(prob), t.h, t.block)
        m = prob.n_solve // t.block
        sub = (t.h, t.h, m - 2 * t.h) if form == "sub" else None
        rng = bcd.sweep_range(x.shape[1], t.Xty_t.shape[1], t.h, t.block,
                              sub, sub is not None)
        nsr = (bcd.rest_ns_update(torch.zeros_like(t.Xty_t), x,
                                  t.rest_touched, t.rest_slot_cols)
               if form == "rest" else None)

        def run(lib, out):
            bcd.fused_sweep_launch(lib, stream, x, t.Xty_t, t.XtX, t.masks,
                                   inv, lam, rho, t.offsets, t.h, t.block,
                                   out, rng, nsr)
    else:
        x = seeded_beta(prob).T.contiguous()
        ns = bcd.gather_neighbor_sums(x, t.nbr, t.overflow)

        def run(lib, out):
            bcd.cd_sweep_launch(lib, stream, x, t.Xty_t, t.XtX, ns, inv, lam,
                                rho, out)
    libs = {"theirs": other[name], "ours": _build.load(name)}
    outs = {k: torch.zeros_like(x) for k in libs}
    for k, lib in libs.items():
        run(lib, outs[k])
    torch.cuda.synchronize()
    same = torch.equal(outs["ours"], outs["theirs"])
    diff = float((outs["ours"] - outs["theirs"]).abs().max())
    ms = {k: [] for k in libs}
    for k in ("theirs", "ours", "ours", "theirs"):
        ms[k].append(time_sweeps(
            lambda *_, out, lib=libs[k]: run(lib, out), (), outs[k]))
    log(f"[against] {name} {form} {label}: K={x.shape[0]} bitwise equal "
        f"{same}, max |ours - theirs| {diff:.3e}; ms per launch ours "
        f"{ms['ours']}, theirs {ms['theirs']} (theirs, ours, ours, theirs)")


def panel_occupancy(lib, K: int) -> int:
    """Blocks an SM of the panel pass of a sweep kernel's library ``lib``
    at K (kernel #1's without the rest input); negative where the library
    does not take K."""
    if hasattr(lib, "fdt_fused_banded_sweep_panel_occupancy"):
        return lib.fdt_fused_banded_sweep_panel_occupancy(K, 0)
    return lib.fdt_cd_block_sweep_panel_occupancy(K)


def phase_xla_sweep(prob, label: str, kernel_ms: float,
                    reps: int = 3) -> None:
    """The XLA tier's sweep on a fused-tier problem's operands: the banded
    neighbour sums of a seeded carry and one ``ops/bcd.coordinate_descent``
    pass (what the unfused banded tier runs where no kernel takes the
    solve), timed by CUDA events beside kernel #1's ``kernel_ms``."""
    from flashdeconv_tpu_torch.ops import bcd

    t = prob.tier
    lam, rho = 0.1, 0.01 * prob.mean_diag
    beta_t = seeded_beta(prob).T.contiguous()
    masks = t.masks.float()
    rest = torch.zeros((0, beta_t.shape[1]), dtype=torch.int32,
                       device=beta_t.device)
    out = torch.empty_like(beta_t)

    def sweep():
        ns = bcd.neighbor_sum_banded(beta_t, t.offsets, masks, rest)
        bcd.coordinate_descent(beta_t, t.Xty_t, t.XtX, ns, t.nnb, lam, rho,
                               out=out)

    with bcd.full_f32_matmul():
        ms = event_ms(sweep, reps=reps)
    log(f"[xla sweep] {label}: K={prob.n_types} the XLA tier's sweep "
        f"{ms:.3f} ms (mean of {reps}), kernel #1 {kernel_ms:.4f} ms: "
        f"{ms / kernel_ms:.1f} times")


def large_k(against) -> None:
    """The ``--large-k`` mode (see the module docstring); ``against``
    maps each ``--against`` DIR to the future of its
    :func:`build_against`."""
    pass_report(small=False)
    others = {d: fut.result() for d, fut in against.items()}
    phase_fused_kernel(prepare(256 * 256, 65)[0], "256x256")
    phase_cd_kernel(prepare(4096, 65, irregular=True)[0], "4096 irregular")
    for irregular, lib, phase in (
            (False, "fused_banded_sweep", phase_fused_kernel),
            (True, "cd_block_sweep", phase_cd_kernel)):
        label = "1M irregular" if irregular else "1000x1000"
        for K in LARGE_TYPES + WIDE_TYPES:
            prob, _ = prepare(SPOTS, K, irregular)
            row = phase(prob, f"{label} K={K}")
            for d, other in others.items():
                if panel_occupancy(other[lib], K) < 0:
                    log(f"[against] {d} {lib}: K={K} is not taken")
                    continue
                phase_against(prob, lib, other, f"{label} K={K} against {d}")
            if K in (128, ATLAS_TYPES) and not irregular:
                phase_fused_vs_unfused(prob)
            if K == ATLAS_TYPES and not irregular:
                phase_xla_sweep(prob, f"{label} K={K}", row["ms"])
            del prob
            torch.cuda.empty_cache()
        knn_graph.cache_clear()


def small_k(against, kernels) -> None:
    """The ``--small-k`` mode (see the module docstring); ``against`` as
    for :func:`large_k`, ``kernels`` as for :func:`counted`."""
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.utils import build_knn_graph

    pass_report(small=True)
    others = {d: fut.result() for d, fut in against.items()}
    coords, _ = knn_graph(SPOTS, False)
    dropped_coords = coords[drop_mask(SPOTS)]
    dropped_A = build_knn_graph(dropped_coords, k=6)
    for K in SMALL_TYPES:
        grid, grid_s = prepare(SPOTS, K)
        label = f"1000x1000 K={K}"
        phase_fused_kernel(grid, label)
        phase_sub_kernel(grid, label)
        for d, other in others.items():
            for form in ("whole", "sub"):
                phase_against(grid, "fused_banded_sweep", other,
                              f"{label} against {d}", form)
        if K == TYPES:
            phase_fused_vs_unfused(grid)
        if K > bcd.REGISTER_PASS_MAX_K:
            objective = ({"fused_banded_objective_large_k": 2}
                         if K <= bcd.OBJECTIVE_KERNEL_MAX_K else {})
            counted(kernels, lambda: {
                **large_k_sweeps(phase_solve(grid, grid_s, label), K),
                **objective})
        del grid
        dropped, _ = prepare_on(dropped_coords, dropped_A, K)
        label = f"1M 1%-dropped grid K={K}"
        if dropped.tier.rest_touched is None:
            raise AssertionError(f"{label}: no rest stream")
        phase_rest_kernel(dropped, label)
        for d, other in others.items():
            phase_against(dropped, "fused_banded_sweep", other,
                          f"{label} against {d}", "rest")
        del dropped
        irr, _ = prepare(SPOTS, K, irregular=True)
        label = f"1M irregular K={K}"
        phase_cd_kernel(irr, label)
        for d, other in others.items():
            phase_against(irr, "cd_block_sweep", other,
                          f"{label} against {d}")
        del irr
        torch.cuda.empty_cache()


def large_k_sweeps(n: int, K: int) -> dict:
    """What ``n`` whole sweeps of kernel #1 at K > 32 show in
    :func:`counted`: ``n`` large-K launches, and as many spot-panel
    launches where that pass runs (K <= ``SPOT_PANEL_MAX_K``)."""
    from flashdeconv_tpu_torch.ops import bcd

    spot = ({"fused_banded_sweep_spot_panel": n}
            if K <= bcd.SPOT_PANEL_MAX_K else {})
    return {"fused_banded_sweep_large_k": n, **spot}


def counted(kernels, path):
    """Run ``path()``, which returns ``{kernel: launches it must show}``,
    with every kernel's count (``kernels``: name -> (wrapper, count
    attribute)) set to 0 just before; each kernel named must have launched
    that many times (at least once), the others not at all. Returns the
    launches."""
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)
    want = path()
    launches = {name: getattr(fn, attr)
                for name, (fn, attr) in kernels.items()}
    for name, n in launches.items():
        if n != want.get(name, 0) or (name in want and n == 0):
            raise AssertionError(f"{name}: {n} launches, expected "
                                 f"{want.get(name, 0)}")
    log(f"[launches] {launches}, expected {want}")
    return launches


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="profile the warm 1M solves instead of the "
                             "smoke run")
    parser.add_argument("--large-k", action="store_true",
                        help="the panel kernels alone instead of the smoke "
                             "run")
    parser.add_argument("--small-k", action="store_true",
                        help="the sweep kernels at K <= 64 alone instead of "
                             "the smoke run")
    parser.add_argument("--objective", action="store_true",
                        help="the fused tier's objective kernel alone at "
                             "1M x 20 instead of the smoke run")
    parser.add_argument("--neighbor-sum", action="store_true",
                        help="the gather tier's neighbour-sum kernel alone "
                             "on the benchmark's tissue section instead of "
                             "the smoke run")
    parser.add_argument("--against", metavar="DIR", action="append",
                        help="with --large-k or --small-k: time the sweep "
                             "kernels of the checkout at DIR in turns with "
                             "this one's (repeatable)")
    parser.add_argument("--multicard", action="store_true",
                        help="the [multicard] phase alone (two cards or "
                             "more) instead of the smoke run")
    parser.add_argument("--multihost-child", nargs=5,
                        metavar=("RANK", "WORLD", "PORT", "DIR", "BACKEND"),
                        help="run one process of a multi-process job (the "
                             "[multihost] and [multicard] phases start them)")
    args = parser.parse_args()
    if args.multihost_child:
        rank, world, port, workdir, backend = args.multihost_child
        multihost_child(int(rank), int(world), int(port), workdir, backend)
        return
    if args.against and not (args.large_k or args.small_k):
        parser.error("--against goes with --large-k or --small-k")
    t_start = time.perf_counter()
    phase_device()
    if args.multicard and torch.cuda.device_count() < 2:
        log(f"[multicard] not run: {torch.cuda.device_count()} card visible")
        sys.exit(1)
    from flashdeconv_tpu_torch.ops import bcd
    from flashdeconv_tpu_torch.ops import countsketch as cs
    from flashdeconv_tpu_torch.utils import grid_coords

    against = {}
    if args.against:  # built while this checkout's kernels build
        pool = concurrent.futures.ThreadPoolExecutor(len(args.against))
        against = {d: pool.submit(build_against, d) for d in args.against}
        pool.shutdown(wait=False)
    phase_build(spills_fatal=not (args.large_k or args.small_k))
    kernels = {
        "fused_banded_sweep": (bcd.fused_banded_sweep, "launches"),
        "fused_banded_sweep_large_k": (bcd.fused_banded_sweep,
                                       "large_k_launches"),
        "fused_banded_sweep_spot_panel": (bcd.fused_banded_sweep,
                                          "spot_panel_launches"),
        "fused_banded_sweep_wide": (bcd.fused_banded_sweep,
                                    "wide_launches"),
        "coordinate_descent_block": (bcd.coordinate_descent_block,
                                     "launches"),
        "coordinate_descent_block_large_k": (bcd.coordinate_descent_block,
                                             "large_k_launches"),
        "coordinate_descent_block_wide": (bcd.coordinate_descent_block,
                                          "wide_launches"),
        "countsketch_project": (cs.countsketch_project_kernel, "launches"),
        "fused_banded_sweep_sub": (bcd.fused_banded_sweep, "sub_launches"),
        "fused_banded_sweep_rest": (bcd.fused_banded_sweep, "rest_launches"),
        "fused_banded_objective": (bcd.fused_banded_objective, "launches"),
        "fused_banded_objective_large_k": (bcd.fused_banded_objective,
                                           "large_k_launches"),
        "neighbor_sum": (bcd.neighbor_sum, "launches"),
    }
    if args.large_k or args.small_k:
        if args.large_k:
            large_k(against)
        else:
            small_k(against, kernels)
        log(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
            "included")
        return
    if args.objective:
        grid, _ = prepare(SPOTS, TYPES)
        if not (grid.use_fused_banded and grid.tier.rest_touched is None):
            raise AssertionError("the 1M grid did not take the fused tier "
                                 "without rest tables")
        phase_objective(grid, "1000x1000 (main path)")
        del grid
        phase_objective(dropped_grid()[0], "1M 1%-dropped grid (main path)")
        phase_objective(prepare(SPOTS, WIDE_OBJECTIVE_TYPES)[0],
                        f"1000x1000 K={WIDE_OBJECTIVE_TYPES}")
        log(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
            "included")
        log(card())
        return
    if args.neighbor_sum:
        for K in (TYPES, 96):
            prob, prob_s = tissue_problem(K)
            log(f"[neighbor-sum] tissue section K={K}: prepared in "
                f"{prob_s:.2f} s")
            phase_neighbor_sum(prob, f"tissue K={K}")
            if K == TYPES:
                phase_gather_route_solves(prob, f"tissue K={K}")
            del prob
            torch.cuda.empty_cache()
        log(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
            "included")
        log(card())
        return
    if args.profile:
        for label, irregular in (("1M grid", False), ("1M irregular", True)):
            phase_profile(prepare(SPOTS, TYPES, irregular)[0], label)
        phase_profile(prepare(SPOTS, 256)[0], "1M grid K=256", reps=2)
        phase_profile_dense_sketch()
        return
    if args.multicard:
        from flashdeconv_tpu_torch import native

        # What a full run has built before [multicard]: the phase alone
        # is timed as it runs there.
        t0 = time.perf_counter()
        knn_graph(SPOTS, False), knn_graph(SPOTS, True)
        job_operands()
        native.available()
        log(f"[multicard] the 1M graphs, the job's operands, the 262k "
            f"counts and the host kernels, which a full run has built "
            f"before the phase: {time.perf_counter() - t0:.1f} s")
        jobs = {}
        counted(kernels, lambda: phase_multicard(jobs))
        log(f"[total] {time.perf_counter() - t_start:.1f} s, the build "
            "included")
        log(card())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return

    # Kernel 1, the fused banded tier (K = 32 / 33: the register form's
    # last K and the panel form's first; 64 / 65: the panel form's register
    # tiles of 2 and 3 rows).
    for K in (6, 32, 33, 64, 65):
        prob, _ = prepare(256 * 256, K)
        phase_fused_kernel(prob, "256x256")
        del prob
    grid, grid_s = prepare(SPOTS, TYPES)
    if not (grid.use_fused_banded and grid.tier.rest_touched is None):
        raise AssertionError("the 1M grid did not take the fused tier "
                             "without rest tables")
    fused_row = phase_fused_kernel(grid, "1000x1000 (main path)")
    objective_row = phase_objective(grid, "1000x1000 (main path)")
    sub_row = phase_sub_kernel(grid, "1000x1000 (main path)")
    phase_fused_vs_unfused(grid)
    # Every solve on the fused tier at K = 20 launches the objective kernel
    # once: here the 2 kernel solves of [solve] (its plain solve runs the
    # plain objective) and the 2 fits.
    launches = counted(kernels, lambda: {
        "fused_banded_sweep": (
            phase_solve(grid, grid_s, "1M grid")
            + phase_fit("262k grid", grid_coords(side=FIT_SIDE),
                        float(FIT_SIDE), FIT_GENES, counts=grid_fit_counts)),
        "fused_banded_objective": 2 + 2})
    fused_launches = launches["fused_banded_sweep"]
    objective_launches = launches["fused_banded_objective"]
    phase_fetch(grid, "1M grid")
    # The objective kernel above the register pass (K = 34: KMAX = 40), on
    # the panel pass's solved carry; each solve launches it once.
    wide, wide_s = prepare(SPOTS, WIDE_OBJECTIVE_TYPES)
    wide_label = f"1000x1000 K={WIDE_OBJECTIVE_TYPES}"
    if not (wide.use_fused_banded and wide.tier.rest_touched is None):
        raise AssertionError(f"{wide_label} did not take the fused tier "
                             "without rest tables")
    objective_wide_row = phase_objective(wide, wide_label)
    spot_row = phase_fused_kernel(wide, wide_label)
    launches = counted(kernels, lambda: {
        **large_k_sweeps(phase_solve(wide, wide_s, wide_label),
                         WIDE_OBJECTIVE_TYPES),
        "fused_banded_objective_large_k": 2})
    # Each of these sweeps ran the spot-panel pass: its entry counts them,
    # the tile pass's (*_large_k) counts none.
    spot_launches = launches["fused_banded_sweep_spot_panel"]
    large_fused_launches = 0
    objective_wide_launches = launches["fused_banded_objective_large_k"]
    del wide
    torch.cuda.empty_cache()
    # The fit's outputs, the lambda path and the streamed feed (kernel #1).
    launches = counted(kernels, phase_outputs)
    fused_launches += launches["fused_banded_sweep"]
    objective_launches += launches["fused_banded_objective"]
    # The sweep-timing protocol (sweeps alone), and a fit untraced and
    # traced (kernel #1, and the objective kernel once a fit).
    launches = counted(kernels, lambda: {
        "fused_banded_sweep": phase_timing(grid, "1M grid", fused_row["ms"])
        + phase_trace(), "fused_banded_objective": 2})
    fused_launches += launches["fused_banded_sweep"]
    objective_launches += launches["fused_banded_objective"]

    # Kernel 1 with the rest stream: grids whose banded split leaves a
    # small remainder.
    coords, A = knn_graph(SPOTS, False)
    dropped, dropped_s = dropped_grid()
    rest_row = phase_rest_kernel(dropped, "1M 1%-dropped grid (main path)")
    objective_rest_row = phase_objective(dropped,
                                         "1M 1%-dropped grid (main path)")
    rest_launches = counted(kernels, lambda: {
        "fused_banded_sweep_rest": phase_timing(
            dropped, "1M 1%-dropped grid", rest_row["ms"])
    })["fused_banded_sweep_rest"]
    phase_fused_vs_unfused(dropped)
    rescue, rescue_s = prepare_on(coords, with_rescue_edges(A), TYPES,
                                  grid=True)
    rest_tier(rescue, f"1M grid + {RESCUE_EDGES} long edges")
    phase_band_cap(grid, rescue)
    phase_fused_vs_unfused(rescue)
    del grid, A
    # The objective kernel's REST instance: the 2 kernel solves of each
    # [solve] and the one fit.
    launches = counted(kernels, lambda: {
        "fused_banded_sweep_rest": (
            phase_solve(dropped, dropped_s, "1M 1%-dropped grid")
            + phase_solve(rescue, rescue_s,
                          f"1M grid + {RESCUE_EDGES} long edges")
            + phase_fit("262k grid, 1% of bins dropped",
                        grid_coords(side=FIT_SIDE)[drop_mask(FIT_SIDE ** 2)],
                        float(FIT_SIDE), FIT_GENES, runs=("once",),
                        counts=dropped_fit_counts)),
        "fused_banded_objective": 2 + 2 + 1})
    rest_launches += launches["fused_banded_sweep_rest"]
    objective_launches += launches["fused_banded_objective"]
    del dropped, rescue
    dropped_fit_counts.cache_clear()
    torch.cuda.empty_cache()

    # Kernel 1's panel form at large K (64 < K <= 256), on the fused tier.
    large_fused_rows = {}
    for K in LARGE_TYPES:
        prob, prob_s = prepare(SPOTS, K)
        if not prob.use_fused_banded:
            raise AssertionError(f"the 1M grid at K = {K} did not take the "
                                 "fused tier")
        large_fused_rows[K] = phase_fused_kernel(prob, f"1000x1000 K={K}")
        if K == 128:
            phase_fused_vs_unfused(prob)
            phase_sub_kernel(prob, f"1000x1000 K={K}")
        if K in (128, 256):
            large_fused_launches += counted(kernels, lambda: {
                "fused_banded_sweep_large_k": phase_solve(
                    prob, prob_s, f"1M grid K={K}")
            })["fused_banded_sweep_large_k"]
        if K == 256:
            phase_fetch(prob, f"1M grid K={K}", reps=3, solves=False)
        del prob
        torch.cuda.empty_cache()
    # Domains of 0.1 x extent and deeper spots keep 96 types identifiable
    # (the K = 20 recipe's 0.25 mixes too many types into every spot).
    large_fused_launches += counted(kernels, lambda: {
        "fused_banded_sweep_large_k": phase_fit(
            f"262k grid K={FIT_LARGE_TYPES}", grid_coords(side=FIT_SIDE),
            float(FIT_SIDE), FIT_GENES, runs=("once",),
            n_types=FIT_LARGE_TYPES, width=0.1, depth=6000.0)
    })["fused_banded_sweep_large_k"]

    # Kernel 2, the gather tier (the same edges).
    for K in (6, 32, 33, 64, 65):
        prob, _ = prepare(4096, K, irregular=True)
        phase_cd_kernel(prob, "4096 irregular")
        del prob
    irr, irr_s = prepare(SPOTS, TYPES, irregular=True)
    if type(irr.tier).__name__ != "GatherTier":
        raise AssertionError("the 1M irregular problem did not take the "
                             "gather tier")
    cd_row = phase_cd_kernel(irr, "1M irregular (main path)")
    if neighbor_sum_calls(irr) != 1:
        raise AssertionError("the 1M irregular problem has hubs' tables")
    ns_row = phase_neighbor_sum(irr, "1M irregular (main path)")
    phase_fetch(irr, "1M irregular")

    def gather_path():
        # The neighbour sums once a sweep and once a solve's objective: the
        # 2 kernel solves of [solve] (its plain solve runs the plain loop)
        # and the 3 fits, whose graphs have no degree cap either.
        sweeps = (phase_solve(irr, irr_s, "1M irregular")
                  + phase_fit("Visium-like hex",
                              hex_coords(VISIUM_COLS, VISIUM_ROWS),
                              float(VISIUM_COLS), FIT_GENES)
                  + phase_fit("100k irregular", irregular_coords(CELLS),
                              float(np.sqrt(CELLS)), FIT_GENES,
                              runs=("once",)))
        return {"coordinate_descent_block": sweeps,
                "neighbor_sum": sweeps + 2 + 2 + 1}

    launches = counted(kernels, gather_path)
    cd_launches = launches["coordinate_descent_block"]
    ns_launches = launches["neighbor_sum"]
    del irr

    # Kernel 2's panel form at large K (64 < K <= 256), on the gather tier.
    large_cd_rows, large_cd_launches = {}, 0
    for K in LARGE_TYPES:
        prob, prob_s = prepare(SPOTS, K, irregular=True)
        if type(prob.tier).__name__ != "GatherTier":
            raise AssertionError(f"the 1M irregular problem at K = {K} did "
                                 "not take the gather tier")
        large_cd_rows[K] = phase_cd_kernel(prob, f"1M irregular K={K}")
        if K == 128:
            def large_solve():
                sweeps = phase_solve(prob, prob_s, f"1M irregular K={K}")
                return {"coordinate_descent_block_large_k": sweeps,
                        "neighbor_sum": sweeps + 2}

            launches = counted(kernels, large_solve)
            large_cd_launches += launches["coordinate_descent_block_large_k"]
            ns_launches += launches["neighbor_sum"]
        del prob
        torch.cuda.empty_cache()

    # The spot-sharded solves: kernel #1 (and its sub-range form) and
    # kernel #2 per shard, several shards on the one card.
    halo = {}
    sharded_launches = counted(kernels, lambda: phase_sharded(halo))
    ns_launches += sharded_launches["neighbor_sum"]
    phase_halo_split(halo.pop("prob"))

    # The mesh across processes: two processes on the card (kernel #1's
    # sub-range form and kernel #2 in each), against one process's 2-shard
    # mesh.
    job = {}
    ns_launches += counted(kernels,
                           lambda: phase_multihost(job))["neighbor_sum"]
    # Several cards: one process's mesh over them and NCCL with one card a
    # process, against one card.
    multicard = {name: 0 for name in kernels}
    if torch.cuda.device_count() >= 2:
        jobs = {}
        multicard.update(counted(kernels, lambda: phase_multicard(jobs)))
        for key, n in jobs.items():
            multicard[key] += n
    else:
        log(f"[multicard] not run: {torch.cuda.device_count()} card visible")

    # The XLA tier (f64, and K > 384): no sweep kernel launches; at
    # K = 338 the tile pass's one-block instances do (kernel #1 on the 1M
    # grid, #2a and the neighbour sums on the 4,096-spot gather problems).
    counted(kernels, phase_f64)
    atlas, _ = atlas_grid()
    wide_row = phase_fused_kernel(atlas, f"1000x1000 K={ATLAS_TYPES}")
    launches = counted(kernels, lambda: phase_atlas_k(atlas))
    del atlas
    torch.cuda.empty_cache()
    ns_launches += launches["neighbor_sum"]
    wide_launches = launches["fused_banded_sweep_wide"]
    large_fused_launches += launches["fused_banded_sweep_large_k"]
    large_cd_launches += launches["coordinate_descent_block_large_k"]
    knn_graph.cache_clear()
    grid_fit_counts.cache_clear()
    job_operands.cache_clear()
    REFERENCE.clear()
    JOB_REFS.clear()

    # Kernel 3, the dense-count sketch on the card.
    cs_row = phase_countsketch_kernel()
    torch.cuda.empty_cache()
    launches = counted(kernels, phase_dense_fit)
    cs_launches = launches["countsketch_project"]
    ns_launches += launches["neighbor_sum"]
    # The host arena, last: it changes the allocator for the process.
    launches = counted(kernels, phase_arena)
    fused_launches += launches["fused_banded_sweep"]
    objective_launches += launches["fused_banded_objective"]
    if "jax" in sys.modules or "flashdeconv_tpu" in sys.modules:
        raise AssertionError("JAX or the JAX package was imported")

    def entry(name, source, replaces, launches, row):
        return {
            "name": name, "route": "cuda",
            "source": f"flashdeconv_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"),
        }

    log(f"[total] {time.perf_counter() - t_start:.1f} s from the card check "
        "to the kernels line, the build included")
    print(json.dumps({"kernels": [
        entry("fused_banded_sweep", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:650",
              fused_launches + multicard["fused_banded_sweep"], fused_row),
        entry("coordinate_descent_block", "cd_block_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:449",
              cd_launches + job["coordinate_descent_block"]
              + multicard["coordinate_descent_block"], cd_row),
        entry("fused_banded_sweep_large_k", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:376",
              large_fused_launches + multicard["fused_banded_sweep_large_k"],
              large_fused_rows[128]),
        entry("fused_banded_sweep_spot_panel", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:376",
              spot_launches + multicard["fused_banded_sweep_spot_panel"],
              spot_row),
        entry("fused_banded_sweep_wide", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:376", wide_launches, wide_row),
        entry("coordinate_descent_block_large_k", "cd_block_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:376", large_cd_launches,
              large_cd_rows[128]),
        entry("countsketch_project", "countsketch_project.cu",
              "flashdeconv_tpu/ops/countsketch.py:112",
              cs_launches + multicard["countsketch_project"], cs_row),
        entry("fused_banded_sweep_sub", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:851",
              sharded_launches["fused_banded_sweep_sub"]
              + job["fused_banded_sweep_sub"]
              + multicard["fused_banded_sweep_sub"], sub_row),
        entry("fused_banded_sweep_rest", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:724", rest_launches, rest_row),
        entry("fused_banded_objective", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:1075",
              objective_launches + multicard["fused_banded_objective"],
              objective_row) | {"rest": {
                  k: objective_rest_row[k]
                  for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}},
        entry("fused_banded_objective_large_k", "fused_banded_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:1075", objective_wide_launches,
              objective_wide_row),
        entry("neighbor_sum", "cd_block_sweep.cu",
              "flashdeconv_tpu/ops/bcd.py:56",
              ns_launches + job["neighbor_sum"] + multicard["neighbor_sum"],
              ns_row),
    ]}), flush=True)
    log(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
