"""The CUDA sweep kernels' sources, run on the CPU, against their plain
PyTorch versions.

There is no CUDA compiler or card on a CPU machine, so
``tests/cuda_emulation/`` compiles a copy of each sweep kernel's source
(``fused_banded_sweep.cu``, ``cd_block_sweep.cu`` and their headers) with
g++ against host stand-ins for the CUDA names: one std::thread per CUDA
thread, a barrier for ``__syncthreads``, blocks one after another. The
copy differs from the source only where a host compiler must: dynamic
shared memory points at a static buffer, each ``<<<...>>>`` launch becomes
a call of the emulator's block loop, the PTX ``max.NaN.f32`` becomes a
NaN-propagating ``fmax``, the PTX ``cp.async`` copy a plain one and an
empty ``asm`` statement (one that hides an address from nvcc) nothing. The
library exports the sources' own C entry points, driven by the wrappers'
own launch code (``ops/bcd.fused_sweep_launch`` / ``cd_sweep_launch``), so
this runs the C entries' range checks and dispatch and the kernels'
indexing, tiling, synchronisation and arithmetic — the register pass at
K <= 32 and the panel pass above, the whole sweep and its sub-range form,
each with and without the rest stream's ``ns_rest`` input — at small
sizes. The emulation of ``cd_block_sweep.cu`` also exports two test-only
entries (``tests/cuda_emulation/emulate.cpp``) that run its register pass
and its panel pass on the same operands at any K <= 64, which must agree
bit for bit; against both, kernel #1's spot-panel pass (32 < K <= 64) is
held bit for bit in the whole sweep, with ``ns_rest`` and in the sub-range
form, and the launch counters on the wrappers' launch path through the
emulated library; so is the tile pass's one-block range (256 < K <= 384,
TM = 9 to 12: kernel #1 whole, with ``ns_rest`` and split, against kernel
#2 on the banded sums), and the TM <= 8 instances' outputs at K = 96 and
256 are held to digests of what the sources gave before the pass took
K > 256. Bounds as on the card (tests/test_torch_kernels.py): atol
5e-5 / rtol 1e-4 against the plain versions, rtol 1e-4 on the statistics,
fused == unfused banded bitwise, a split sweep == the whole sweep bitwise.
The objective kernel of ``fused_banded_sweep.cu`` runs through the same
library (its C entry and the wrapper's launch and reduction code) within
rtol 1e-5 of the plain path, each of its five sums within rtol 1e-6 of
the plain path's, bitwise against itself; the C entry's refusals are run
too, and a CPU carry is held to the plain path. The gather tier's
neighbour-sum kernel of ``cd_block_sweep.cu`` runs through its C entry and
the wrapper's launch code (``ops/bcd.neighbor_sum_launch``), bit for bit
the plain loop (f32 bit patterns, so -0.0 counts), and a whole gather-tier
solve loop through it bit for bit the plain one.
"""

import contextlib
import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.ops import _build
from flashdeconv_tpu_torch.ops import bcd as tbcd
from flashdeconv_tpu_torch.utils.graph import build_knn_graph
from torch_problems import fused_problem, gather_problem, with_rest

EMULATION = Path(__file__).resolve().with_name("cuda_emulation")
CSRC = Path(tbcd.__file__).resolve().with_name("csrc")
# Source text -> host text; each must occur in the sources.
HOST_EDITS = {
    "gs_pass.cuh": [
        ('asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));',
         "m = (a != a || b != b) ? NAN : std::fmax(a, b);"),
        ("    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);\n"
         '    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"\n'
         '                 : : "r"(s), "l"(src) : "memory");',
         "    *dst = *src;"),
        ('asm volatile("cp.async.wait_all;" : : : "memory");', ""),
        ('asm volatile("" : "+l"(p));', ""),
    ],
    "fused_banded_sweep.cu": [
        ("extern __shared__ float4 smem4[];", "float4* smem4 = fdt_emu_smem;"),
    ],
    "cd_block_sweep.cu": [
        ("extern __shared__ float4 smem4[];", "float4* smem4 = fdt_emu_smem;"),
    ],
}
# kernel<<<blocks, FDT_THREADS, smem, stream>>>(args); -> the block loop.
LAUNCH = re.compile(
    r"(\w[\w<>, ]*?)\s*<<<blocks, FDT_THREADS, smem, \w+>>>\((.*?)\);",
    re.S)


def _host_copy(src: Path, dst: Path) -> None:
    text = src.read_text()
    for old, new in HOST_EDITS.get(src.name, []):
        assert old in text, f"{src.name} no longer has {old!r}"
        text = text.replace(old, new)
    if src.suffix == ".cu":
        text, n = LAUNCH.subn(
            r"fdt_emu_launch(blocks, smem, [&] { \1(\2); });", text)
        assert n >= 2, f"{src.name}: expected its launches"
        assert "<<<" not in text, f"{src.name}: a launch was not emulated"
    dst.write_text(text)


@pytest.fixture(scope="module")
def emulator(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emulation")
    for name in ("gs_pass.cuh", "gs_pass_panel.cuh",
                 "fused_banded_sweep.cu", "cd_block_sweep.cu"):
        _host_copy(CSRC / name, out / name)
    shutil.copy(EMULATION / "cuda_runtime.h", out)
    builds = (("fused", "-DFUSED", "fused_banded_sweep"),
              ("cd", "-UFUSED", "cd_block_sweep"))
    procs = {}
    for name, flag, _ in builds:
        so = out / f"emu_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", flag, f"-I{out}", "-o", str(so),
             str(EMULATION / "emulate.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, _, kernel in builds:
        so, proc = procs[name]
        log = proc.communicate()[0]
        assert proc.returncode == 0, f"g++ failed for {name}:\n{log}"
        libs[name] = ctypes.CDLL(str(so))
        _build._declare(kernel, libs[name])
    return libs


def _stats(partials: torch.Tensor):
    return list(torch.amax(partials, dim=1))


def emulated_cd(emulator, beta_t, Xty_t, XtX, ns_t, inv_den_t, lam, rho):
    out = torch.full_like(beta_t, 7.0)
    partials = tbcd.cd_sweep_launch(emulator["cd"], 0, beta_t, Xty_t, XtX,
                                    ns_t, inv_den_t, lam, rho, out)
    return (out, *_stats(partials))


def emulated_fused(emulator, carry, Xty_t, XtX, masks, inv_den_t, lam, rho,
                   offsets, h, block, out=None, sub=None, ns_rest_t=None):
    """The emulated kernel through the wrapper's launch code; without
    ``out`` the new carry (or sub-carry) starts as 7.0 everywhere."""
    rng = tbcd.sweep_range(carry.shape[1], Xty_t.shape[1], h, block, sub,
                           out is not None and sub is not None)
    if out is None:
        out = torch.full((carry.shape[0], rng.n_sub + 2 * h * block), 7.0)
    partials = tbcd.fused_sweep_launch(
        emulator["fused"], 0, carry, Xty_t, XtX, masks,
        inv_den_t.contiguous(), lam, rho, offsets, h, block, out, rng,
        ns_rest_t)
    return (out, *_stats(partials))


def _close(got, ref):
    torch.testing.assert_close(got[0], ref[0], atol=5e-5, rtol=1e-4,
                               equal_nan=True)
    for g, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(g, r.to(g.dtype), atol=0.0, rtol=1e-4,
                                   equal_nan=True)


@pytest.mark.parametrize("K", [20, 24, 33, 48, 64, 65, 80, 96, 129, 255,
                               256])
def test_emulated_cd_kernel_matches_plain_version(emulator, K):
    """100 spots: a ragged last block at every K; the register pass at
    K = 20 (KMAX = 24) and 24 (KMAX = K); above K = 32 a whole number of
    panels (48, 64, 80, 96, 256), a ragged last panel (33, 65, 129, 255)
    and register tiles of 2 to 8 rows whose last rows pass K (33, 48, 65,
    129, 255)."""
    p = gather_problem(n=100, n_types=K, seed=K)
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "coords"}
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(t["beta_t"]), t["nbr_t"])
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5)
    args = (t["beta_t"], t["Xty_t"], t["XtX"], ns, inv, 0.5, 0.1)
    got = emulated_cd(emulator, *args)
    ref = tbcd.coordinate_descent_block_reference(*args)
    _close(got, ref)
    assert (got[0] >= 0).all()


@pytest.mark.parametrize("K", [20, 24, 33, 34, 40, 45, 47, 48, 56, 61, 63,
                               64, 65, 80, 96, 129, 255, 256])
def test_emulated_fused_kernel_matches_plain_and_unfused(emulator, K):
    """A 20 x 20 grid with a 40-spot pad, which splits a 64-spot block of
    the panel form: the plain version within the card's bounds, pad slabs
    zero, and the coordinate-descent kernel on the banded neighbour sums
    of the same carry bit for bit."""
    p = fused_problem(side=20, n_types=K, seed=K, block=40)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5)
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    got = emulated_fused(emulator, *args)
    _close(got, tbcd.fused_banded_sweep_reference(*args))
    pad = p["h"] * p["block"]
    n = t["Xty_t"].shape[1]
    assert (got[0][:, :pad] == 0).all() and (got[0][:, -pad:] == 0).all()
    beta_t = t["carry"][:, pad:pad + n].contiguous()
    ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"], t["masks"].float(),
                                  torch.zeros((0, n), dtype=torch.int32))
    unfused = emulated_cd(emulator, beta_t, t["Xty_t"], t["XtX"], ns, inv,
                          0.5, 0.1)
    assert torch.equal(unfused[0], got[0][:, pad:pad + n])


@pytest.mark.parametrize("where", ["XtX", "inv_den", "lambda"])
def test_emulated_panel_pass_propagates_nan(emulator, where):
    p = gather_problem(n=70, n_types=96, seed=1)
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "coords"}
    lam = float("nan") if where == "lambda" else 0.5
    if where == "XtX":
        t["XtX"][10, 1] = float("nan")
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(t["beta_t"]), t["nbr_t"])
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], lam).contiguous()
    if where == "inv_den":
        inv[7, 30] = float("nan")
    args = (t["beta_t"], t["Xty_t"], t["XtX"], ns, inv, lam, 0.1)
    got = emulated_cd(emulator, *args)
    ref = tbcd.coordinate_descent_block_reference(*args)
    assert torch.isnan(ref[0]).any() and torch.isnan(got[1])
    _close(got, ref)


def _split_problem(K):
    """A 20 x 20 grid in 10 blocks of 40 spots, h = 1: a split sweep has
    an interior call of 8 blocks and two boundary calls of one."""
    p = fused_problem(side=20, n_types=K, seed=K + 1, block=40)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5)
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    return p, args


@pytest.mark.parametrize("K", [20, 24, 33, 34, 40, 45, 47, 48, 56, 61, 63,
                               64, 128, 256])
def test_emulated_sub_range_recomposes_the_whole_sweep(emulator, K):
    """The interior and both boundary calls, each into one full carry:
    bit for bit the whole sweep's data columns, the statistics' max equal
    to the whole sweep's, the carry's pads untouched; each call alone (a
    sub-carry of its own) against the plain version."""
    p, args = _split_problem(K)
    h, m = p["h"], args[1].shape[1] // p["block"]
    pad = h * p["block"]
    whole = emulated_fused(emulator, *args)
    out = torch.full_like(args[0], 7.0)
    stats = []
    for sub in ((h, h, m - 2 * h), (0, 0, h), (m - h, m - h, h)):
        got = emulated_fused(emulator, *args, out=out, sub=sub)
        assert got[0] is out
        stats.append(got[1:])
        alone = emulated_fused(emulator, *args, sub=sub)
        _close(alone, tbcd.fused_banded_sweep_reference(*args, sub=sub))
        assert (alone[0][:, :pad] == 0).all()
        assert (alone[0][:, -pad:] == 0).all()
    assert torch.equal(out[:, pad:-pad], whole[0][:, pad:-pad])
    assert (out[:, :pad] == 7.0).all() and (out[:, -pad:] == 7.0).all()
    assert max(s[0] for s in stats) == whole[1]
    assert max(s[1] for s in stats) == whole[2]


def test_emulated_sub_range_reads_an_assembled_window(emulator):
    """A boundary call on a small assembled buffer (carry_start != data
    start, as the JAX mesh's side buffers) writes the same columns as the
    same call on the full carry."""
    p, args = _split_problem(20)
    h, block = p["h"], p["block"]
    m = args[1].shape[1] // block
    side = args[0][:, (m - 2 * h) * block:].contiguous()  # blocks m-2h..
    full = emulated_fused(emulator, *args, sub=(m - h, m - h, h))
    part = emulated_fused(emulator, side, *args[1:], sub=(h, m - h, h))
    assert torch.equal(full[0], part[0])
    assert full[1] == part[1] and full[2] == part[2]


def test_emulated_entry_refuses_a_range_off_the_carry(emulator):
    """The C entry's own check (the wrapper's is bypassed here)."""
    p, args = _split_problem(20)
    h, block = p["h"], p["block"]
    m = args[1].shape[1] // block
    bad = tbcd.SweepRange(in_col0=block, data0=0, n_sub=m * block,
                          out_col0=0, write_pads=True)
    out = torch.empty((args[0].shape[0], (m + 2 * h) * block))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tbcd.fused_sweep_launch(emulator["fused"], 0, args[0], args[1],
                                args[2], args[3], args[4].contiguous(),
                                0.5, 0.1, p["offsets"], h, block, out, bad)


def _rest_problem(K, seed):
    """The 20 x 20 grid of :func:`_split_problem` plus 60 random rest edges,
    and its rest stream's ``ns_rest`` refreshed from the carry."""
    p = with_rest(fused_problem(side=20, n_types=K, seed=seed, block=40),
                  n_edges=60, seed=seed)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5)
    nsr = tbcd.rest_ns_update(torch.zeros_like(t["Xty_t"]), t["carry"],
                              t["touched"], t["slot_cols"])
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, 0.5, 0.1,
            p["offsets"], p["h"], p["block"])
    return p, t, args, nsr


@pytest.mark.parametrize("K", [6, 20, 24, 33, 34, 40, 47, 48, 56, 63, 64,
                               96, 256])
def test_emulated_fused_kernel_with_rest_matches_plain_and_unfused(emulator,
                                                                   K):
    """The kernel with ``ns_rest``: the plain version within the card's
    bounds, pad slabs zero, and the coordinate-descent kernel on the
    unfused banded sums with the same rest table bit for bit."""
    p, t, args, nsr = _rest_problem(K, seed=K + 3)
    got = emulated_fused(emulator, *args, ns_rest_t=nsr)
    _close(got, tbcd.fused_banded_sweep_reference(*args, ns_rest_t=nsr))
    pad, n = p["h"] * p["block"], t["Xty_t"].shape[1]
    assert (got[0][:, :pad] == 0).all() and (got[0][:, -pad:] == 0).all()
    beta_t = t["carry"][:, pad:pad + n].contiguous()
    ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"], t["masks"].float(),
                                  t["rest_t"])
    unfused = emulated_cd(emulator, beta_t, t["Xty_t"], t["XtX"], ns,
                          args[4], 0.5, 0.1)
    assert torch.equal(unfused[0], got[0][:, pad:pad + n])
    no_rest = emulated_fused(emulator, *args)
    assert not torch.equal(no_rest[0], got[0])


@pytest.mark.parametrize("K", [20, 34, 47, 48, 64, 128])
def test_emulated_sub_range_with_rest_recomposes_the_whole_sweep(emulator,
                                                                 K):
    """The interior and both boundary calls with ``ns_rest`` (indexed by
    data column, like Xty) into one full carry: the whole sweep with
    ``ns_rest`` bit for bit, its statistics' max equal."""
    p, t, args, nsr = _rest_problem(K, seed=K + 5)
    h, m = p["h"], t["Xty_t"].shape[1] // p["block"]
    pad = h * p["block"]
    whole = emulated_fused(emulator, *args, ns_rest_t=nsr)
    out = torch.full_like(args[0], 7.0)
    stats = []
    for sub in ((h, h, m - 2 * h), (0, 0, h), (m - h, m - h, h)):
        stats.append(emulated_fused(emulator, *args, out=out, sub=sub,
                                    ns_rest_t=nsr)[1:])
        alone = emulated_fused(emulator, *args, sub=sub, ns_rest_t=nsr)
        _close(alone, tbcd.fused_banded_sweep_reference(
            *args, sub=sub, ns_rest_t=nsr))
    assert torch.equal(out[:, pad:-pad], whole[0][:, pad:-pad])
    assert (out[:, :pad] == 7.0).all() and (out[:, -pad:] == 7.0).all()
    assert max(s[0] for s in stats) == whole[1]
    assert max(s[1] for s in stats) == whole[2]


@pytest.mark.parametrize("K,nbytes", [(33, 33_280), (64, 37_376),
                                      (65, 45_568), (96, 49_664),
                                      (128, 61_952), (256, 111_104),
                                      (257, 119_296), (300, 131_584),
                                      (338, 147_968), (384, 160_256)])
def test_emulated_panel_queries(emulator, K, nbytes):
    """The C entries ``chip_smoke.py --large-k`` reads: the panel pass's
    shared memory at K (the figures the note at the head of
    gs_pass_panel.cuh gives), the same in both libraries, and an
    occupancy answer from the instance of K's register tile (the
    emulator's stand-in holds one block an SM); K outside the panel range
    is refused."""
    fused, cd = emulator["fused"], emulator["cd"]
    assert fused.fdt_panel_pass_smem_bytes(K) == nbytes
    assert cd.fdt_panel_pass_smem_bytes(K) == nbytes
    assert fused.fdt_fused_banded_sweep_panel_occupancy(K, 0) == 1
    assert fused.fdt_fused_banded_sweep_panel_occupancy(K, 1) == 1
    assert cd.fdt_cd_block_sweep_panel_occupancy(K) == 1
    for bad in (tbcd.REGISTER_PASS_MAX_K, tbcd.KERNEL_MAX_K + 1):
        assert fused.fdt_fused_banded_sweep_panel_occupancy(bad, 0) == -1
        assert cd.fdt_cd_block_sweep_panel_occupancy(bad) == -1


@pytest.mark.parametrize("K", [1, 6, 8, 20, 24, 32])
def test_emulated_register_queries(emulator, K):
    """The register forms' occupancy entries ``chip_smoke.py --small-k``
    reads: an answer from the instance of K's KMAX (the emulator's
    stand-in holds one block an SM) through ``REGISTER_PASS_MAX_K``, and a
    refusal outside 1..REGISTER_PASS_MAX_K."""
    fused, cd = emulator["fused"], emulator["cd"]
    assert fused.fdt_fused_banded_sweep_register_occupancy(K, 0) == 1
    assert fused.fdt_fused_banded_sweep_register_occupancy(K, 1) == 1
    assert cd.fdt_cd_block_sweep_register_occupancy(K) == 1
    for bad in (0, tbcd.REGISTER_PASS_MAX_K + 1):
        assert fused.fdt_fused_banded_sweep_register_occupancy(bad, 0) == -1
        assert cd.fdt_cd_block_sweep_register_occupancy(bad) == -1


def _emulated_pass(emulator, form, beta_t, Xty_t, XtX, ns_t, inv_den_t, lam,
                   rho):
    """Kernel #2's register or panel pass through the emulation's
    test-only entry ``fdt_emu_<form>_pass``: (new beta, max_diff,
    max_abs)."""
    fn = getattr(emulator["cd"], f"fdt_emu_{form}_pass")
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    K, n = beta_t.shape
    spots = 256 if form == "register" else 64
    out = torch.full_like(beta_t, 7.0)
    partials = torch.empty((2, -(-n // spots)))
    assert fn(beta_t.data_ptr(), out.data_ptr(), Xty_t.data_ptr(),
              ns_t.data_ptr(), inv_den_t.data_ptr(), XtX.data_ptr(), K, n,
              lam, rho, partials.data_ptr()) == 0
    return (out, *_stats(partials))


@pytest.mark.parametrize("K", [6, 20, 24, 32, 33, 48, 64])
def test_emulated_register_and_panel_passes_are_bitwise_equal(emulator, K):
    """The register pass (``gs_pass_spot``) and the panel pass
    (``gs_pass_panel``) have one association, so on the same operands
    they give the same beta and statistics bit for bit at every K <= 64,
    either side of the crossover; both within the card's bounds of the
    plain version. 300 spots: a ragged last block of each form."""
    p = gather_problem(n=300, n_types=K, seed=K + 40)
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "coords"}
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(t["beta_t"]), t["nbr_t"])
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5).contiguous()
    args = (t["beta_t"], t["Xty_t"], t["XtX"], ns, inv, 0.5, 0.1)
    reg = _emulated_pass(emulator, "register", *args)
    panel = _emulated_pass(emulator, "panel", *args)
    assert torch.equal(reg[0], panel[0])
    assert reg[1] == panel[1] and reg[2] == panel[2]
    _close(reg, tbcd.coordinate_descent_block_reference(*args))


# -- kernel #1's spot-panel pass (32 < K <= 64) ------------------------------

# K = 45, 47, 61 and 63 end on a last panel of 13 to 15 rows.
SPOT_KS = [33, 34, 40, 45, 47, 48, 56, 61, 63, 64]


@pytest.mark.parametrize("form", ["whole", "rest", "sub"])
@pytest.mark.parametrize("K", SPOT_KS)
def test_emulated_spot_panel_pass_is_bitwise_the_tile_pass(emulator, K,
                                                           form):
    """Kernel #1 on the spot-panel pass against kernel #2's tile pass and
    its register pass (the emulation's test-only entries, which run either
    at any K <= 64) on the unfused banded sums, on the 20 x 20 grid with 60
    rest edges: the whole sweep, the whole sweep with ``ns_rest``, and the
    sub-range form's three calls into one full carry give the same beta
    and statistics bit for bit: one association under three schedules."""
    p, t, args, nsr = _rest_problem(K, seed=K + 11)
    pad, n = p["h"] * p["block"], t["Xty_t"].shape[1]
    rest = form == "rest"
    if form == "sub":
        h, m = p["h"], n // p["block"]
        out = torch.full_like(args[0], 7.0)
        stats = [emulated_fused(emulator, *args, out=out, sub=sub)[1:]
                 for sub in ((h, h, m - 2 * h), (0, 0, h),
                             (m - h, m - h, h))]
        spot = (out, max(s[0] for s in stats), max(s[1] for s in stats))
    else:
        spot = emulated_fused(emulator, *args,
                              ns_rest_t=nsr if rest else None)
    beta_t = t["carry"][:, pad:pad + n].contiguous()
    table = t["rest_t"] if rest else torch.zeros((0, n), dtype=torch.int32)
    ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"], t["masks"].float(),
                                  table)
    for other in ("panel", "register"):
        ref = _emulated_pass(emulator, other, beta_t, t["Xty_t"], t["XtX"],
                             ns, args[4].contiguous(), 0.5, 0.1)
        assert torch.equal(ref[0], spot[0][:, pad:pad + n])
        assert ref[1] == spot[1] and ref[2] == spot[2]


@pytest.mark.parametrize("K", [34, 47])
@pytest.mark.parametrize("where", ["XtX", "inv_den", "lambda"])
def test_emulated_spot_panel_pass_propagates_nan(emulator, where, K):
    """A NaN in XtX, inv_den or lambda: NaN where the plain version has
    it, a NaN max_diff (so the sweep cannot pass for converged), and
    kernel #2's tile pass's output on the unfused banded sums (NaN in the
    same places, the rest bit for bit)."""
    p = fused_problem(side=20, n_types=K, seed=5, block=40)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    lam = float("nan") if where == "lambda" else 0.5
    if where == "XtX":
        t["XtX"][10, 1] = float("nan")
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], lam).contiguous()
    if where == "inv_den":
        inv[7, 30] = float("nan")
    args = (t["carry"], t["Xty_t"], t["XtX"], t["masks"], inv, lam, 0.1,
            p["offsets"], p["h"], p["block"])
    got = emulated_fused(emulator, *args)
    ref = tbcd.fused_banded_sweep_reference(*args)
    assert torch.isnan(ref[0]).any() and torch.isnan(got[1])
    _close(got, ref)
    pad, n = p["h"] * p["block"], t["Xty_t"].shape[1]
    beta_t = t["carry"][:, pad:pad + n].contiguous()
    ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"], t["masks"].float(),
                                  torch.zeros((0, n), dtype=torch.int32))
    tile = emulated_cd(emulator, beta_t, t["Xty_t"], t["XtX"], ns, inv, lam,
                       0.1)
    torch.testing.assert_close(got[0][:, pad:pad + n], tile[0], atol=0.0,
                               rtol=0.0, equal_nan=True)


@pytest.mark.parametrize("K,nbytes", [(33, 71_440), (34, 72_608),
                                      (48, 91_264), (64, 131_200)])
def test_emulated_spot_panel_queries(emulator, K, nbytes):
    """The spot-panel pass's shared memory at K (the transposed XtX, the
    beta_old tile, the kept deltas and the band offsets: the figures of
    the note in gs_pass_panel.cuh), an occupancy answer from its instance,
    and one partial a 256-column block, where the tile pass (every K
    above ``SPOT_PANEL_MAX_K``) writes one a 64-column block: the wrapper
    sizes its partials from that."""
    fused = emulator["fused"]
    assert tbcd.REGISTER_PASS_MAX_K < K <= tbcd.SPOT_PANEL_MAX_K
    assert fused.fdt_spot_panel_pass_smem_bytes(K) == nbytes
    assert fused.fdt_fused_banded_sweep_panel_occupancy(K, 0) == 1
    assert fused.fdt_fused_banded_sweep_panel_occupancy(K, 1) == 1
    assert fused.fdt_fused_banded_sweep_blocks(1000, K) == 4
    assert fused.fdt_fused_banded_sweep_blocks(
        1000, tbcd.SPOT_PANEL_MAX_K + 1) == 16


@pytest.mark.parametrize("K", [20, 34, 47, 64, 65, 96, 256, 257, 384])
def test_spot_panel_launches_count_the_new_pass(emulator, K, monkeypatch):
    """The wrappers' launch path (``_fused_banded_sweep_cuda``, the
    library the emulator's): three whole sweeps, one with ``ns_rest``, and
    a split sweep's three calls. ``spot_panel_launches`` counts one a
    launch of every form at 32 < K <= ``SPOT_PANEL_MAX_K`` (34, 47, 64) and
    none at K = 20 or where the tile pass runs (65, 96, 256, 257, 384);
    ``wide_launches`` one a launch of every form at K > 256 (257, 384);
    ``large_k_launches`` still counts every whole sweep without ``ns_rest``
    at K > 32, and ``launches`` those at K <= 32."""
    monkeypatch.setattr(_build, "load", lambda name: emulator["fused"])
    monkeypatch.setattr(_build, "launch_stream",
                        lambda *ops: contextlib.nullcontext(0))
    p, t, args, nsr = _rest_problem(K, seed=K + 13)
    carry, Xty_t, XtX, masks, inv, lam, rho, offsets, h, block = args
    fn = tbcd.fused_banded_sweep
    names = ("launches", "large_k_launches", "rest_launches", "sub_launches",
             "spot_panel_launches", "wide_launches")
    before = {a: getattr(fn, a) for a in names}

    def sweep(out, sub=None, ns_rest_t=None):
        rng = tbcd.sweep_range(carry.shape[1], Xty_t.shape[1], h, block,
                               sub, sub is not None)
        return tbcd._fused_banded_sweep_cuda(
            carry, Xty_t, XtX, masks, inv.contiguous(), lam, rho, offsets,
            h, block, out, rng, sub, ns_rest_t)

    whole = [sweep(torch.empty_like(carry)) for _ in range(2)]
    sweep(torch.empty_like(carry), ns_rest_t=nsr)
    m = Xty_t.shape[1] // block
    split = torch.full_like(carry, 0.0)
    for sub in ((h, h, m - 2 * h), (0, 0, h), (m - h, m - h, h)):
        sweep(split, sub=sub)
    assert torch.equal(whole[0][0], whole[1][0])
    assert torch.equal(split[:, h * block:-h * block],
                       whole[0][0][:, h * block:-h * block])
    spot = tbcd.REGISTER_PASS_MAX_K < K <= tbcd.SPOT_PANEL_MAX_K
    large = K > tbcd.REGISTER_PASS_MAX_K
    assert {a: getattr(fn, a) - before[a] for a in names} == {
        "launches": 0 if large else 2, "large_k_launches": 2 if large else 0,
        "rest_launches": 1, "sub_launches": 3,
        "spot_panel_launches": 6 if spot else 0,
        "wide_launches": 6 if K > tbcd.WIDE_ABOVE_K else 0}


# -- the tile pass above K = 256 (kernels #1b and #2a, TM = 9 to 12) ---------

# TM = 9, 10, 11 and 12: a ragged last panel and register tile (257, 300,
# 338) and a whole one (384 = KERNEL_MAX_K).
WIDE_KS = [257, 300, 338, tbcd.KERNEL_MAX_K]


@pytest.mark.parametrize("form", ["whole", "rest", "sub"])
@pytest.mark.parametrize("K", WIDE_KS)
def test_emulated_wide_tile_pass_is_bitwise_fused_and_unfused(emulator, K,
                                                             form):
    """Kernel #1's tile pass at 256 < K <= ``KERNEL_MAX_K`` against kernel
    #2's on the plain twin's banded sums (``neighbor_sum_banded``), on the
    20 x 20 grid with 60 rest edges: the whole sweep, the whole sweep with
    ``ns_rest`` and the sub-range form's three calls into one full carry
    give the same beta and statistics bit for bit; kernel #1 is within the
    card's bounds of the plain twin (``fused_banded_sweep_reference``), its
    pad slabs zero."""
    assert 256 < K <= tbcd.KERNEL_MAX_K
    p, t, args, nsr = _rest_problem(K, seed=K + 17)
    pad, n = p["h"] * p["block"], t["Xty_t"].shape[1]
    rest = form == "rest"
    if form == "sub":
        h, m = p["h"], n // p["block"]
        out = torch.full_like(args[0], 7.0)
        stats = [emulated_fused(emulator, *args, out=out, sub=sub)[1:]
                 for sub in ((h, h, m - 2 * h), (0, 0, h),
                             (m - h, m - h, h))]
        got = (out, max(s[0] for s in stats), max(s[1] for s in stats))
        assert (out[:, :pad] == 7.0).all() and (out[:, -pad:] == 7.0).all()
    else:
        got = emulated_fused(emulator, *args,
                             ns_rest_t=nsr if rest else None)
        _close(got, tbcd.fused_banded_sweep_reference(
            *args, ns_rest_t=nsr if rest else None))
        assert (got[0][:, :pad] == 0).all() and (got[0][:, -pad:] == 0).all()
    beta_t = t["carry"][:, pad:pad + n].contiguous()
    table = t["rest_t"] if rest else torch.zeros((0, n), dtype=torch.int32)
    ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"], t["masks"].float(),
                                  table)
    unfused = emulated_cd(emulator, beta_t, t["Xty_t"], t["XtX"], ns,
                          args[4].contiguous(), 0.5, 0.1)
    assert torch.equal(unfused[0], got[0][:, pad:pad + n])
    assert unfused[1] == got[1] and unfused[2] == got[2]
    _close(unfused, tbcd.coordinate_descent_block_reference(
        beta_t, t["Xty_t"], t["XtX"], ns, args[4], 0.5, 0.1))


def _digest(*tensors) -> str:
    """SHA-256 (first 16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# Digests of the emulated tile pass's outputs (new carry, then the two
# statistics) at K = 96 (TM = 3) and 256 (TM = 8), as the sources gave them
# before the pass took K > 256: kernel #1 whole and with ns_rest, kernel #2
# on the same carry's banded sums.
TILE_K_DIGESTS = {
    (96, "whole"): "173da0da4afe9e52", (96, "rest"): "2bbbb70ab535d0b4",
    (96, "cd"): "0babbfe8d780cead",
    (256, "whole"): "30e51de64bc61aeb", (256, "rest"): "2716667bd2f653ae",
    (256, "cd"): "9f79165aaff2fbf3",
}


@pytest.mark.parametrize("K,form", sorted(TILE_K_DIGESTS))
def test_emulated_tile_pass_at_k_up_to_256_is_unchanged(emulator, K, form):
    """The TM <= 8 instances give bit for bit what they gave before the
    tile pass was carried past K = 256."""
    p, t, args, nsr = _rest_problem(K, seed=K + 19)
    if form == "cd":
        pad, n = p["h"] * p["block"], t["Xty_t"].shape[1]
        beta_t = t["carry"][:, pad:pad + n].contiguous()
        ns = tbcd.neighbor_sum_banded(beta_t, p["offsets"],
                                      t["masks"].float(), t["rest_t"])
        got = emulated_cd(emulator, beta_t, t["Xty_t"], t["XtX"], ns,
                          args[4].contiguous(), 0.5, 0.1)
    else:
        got = emulated_fused(emulator, *args,
                             ns_rest_t=nsr if form == "rest" else None)
    assert _digest(*got) == TILE_K_DIGESTS[(K, form)]


def _objective_problem(K, rest, seed):
    """The 20 x 20 grid of :func:`_split_problem` (with 60 random rest
    edges when ``rest``) and its operands as tensors."""
    p = fused_problem(side=20, n_types=K, seed=seed, block=40)
    if rest:
        p = with_rest(p, n_edges=60, seed=seed)
    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in p.items()}
    return p, t


def emulated_objective(emulator, p, t, rest, yty=5e3, lam=0.5, rho=0.1):
    """The emulated objective kernel through the wrapper's launch code and
    reduction, the rest sums refreshed from the carry as the wrapper's
    route does: (objective, partials, the five sums)."""
    nsr = tbcd.rest_ns_update(torch.zeros_like(t["Xty_t"]), t["carry"],
                              t["touched"], t["slot_cols"]) if rest else None
    partials = tbcd.fused_objective_launch(
        emulator["fused"], 0, t["carry"], t["Xty_t"], t["XtX"], t["masks"],
        t["nnb"], p["offsets"], p["h"], p["block"], nsr)
    sums = tbcd.objective_sums_from_partials(partials)
    return tbcd.objective_from_terms(sums, yty, lam, rho), partials, sums


def plain_objective(p, t, rest, yty=5e3, lam=0.5, rho=0.1):
    kw = dict(rest_touched=t["touched"],
              rest_slot_cols=t["slot_cols"]) if rest else {}
    return tbcd.objective_terms_banded_fused(
        t["carry"], t["Xty_t"], t["XtX"], yty, p["offsets"], t["masks"], lam,
        rho, p["h"], p["block"], nnb=t["nnb"], **kw)


@pytest.mark.parametrize("rest", [False, True])
@pytest.mark.parametrize("K", [6, 20, 24, 32, 33, 34, 40, 48, 56])
def test_emulated_objective_matches_plain_path(emulator, K, rest):
    """The objective kernel (KMAX = 8, 24, 24, 32 and, above the register
    pass, 40, 40, 40, 48, 56, whose band sums come 8 rows at a time;
    with and without the rest input), its partials reduced and formed by
    the wrapper's code, within rtol 1e-5 of the plain path (the JAX parity
    tests' bound), in f32; two blocks, the last ragged. Each of the five
    sums on its own (cross, degree, adjacency, L1, quad) within rtol 1e-6
    of the plain path's: the emulated kernel's measured gap is at most
    1.9e-7 a sum over 3 seeds of each case, so a term left out or wrong
    shows however small it is beside the others. A second launch gives
    the same partials, bit for bit."""
    p, t = _objective_problem(K, rest, seed=K + 60)
    got, partials, sums = emulated_objective(emulator, p, t, rest)
    assert torch.equal(emulated_objective(emulator, p, t, rest)[1], partials)
    ref = plain_objective(p, t, rest)
    kw = dict(rest_touched=t["touched"],
              rest_slot_cols=t["slot_cols"]) if rest else {}
    ref_sums = tbcd.fused_banded_objective_sums_reference(
        t["carry"], t["Xty_t"], t["XtX"], p["offsets"], t["masks"], p["h"],
        p["block"], t["nnb"], **kw)
    assert got.dtype == ref.dtype == torch.float32
    assert partials.shape == (5, 2)
    assert sums.shape == ref_sums.shape == (5,)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    np.testing.assert_allclose(sums.numpy(), ref_sums.numpy(), rtol=1e-6)


# SHA-256 (first 16 hex digits) of the emulated objective partials of
# test_emulated_objective_matches_plain_path's problems at K <= 32, as the
# sources gave them before the kernel took K > 32 (the register pass's
# instances, KMAX = 8..32, compiled from unchanged code).
REGISTER_K_PARTIALS = {
    (6, False): "5a44c0fd14af60b2", (6, True): "e400ca0a31e7716d",
    (20, False): "65b547e08772da7b", (20, True): "7638d2831a64d936",
    (24, False): "0fc4e539b714fc1d", (24, True): "e00ef5675f9196a0",
    (32, False): "cfd12d68b7422d86", (32, True): "a54d883a30279e28",
}


@pytest.mark.parametrize("K,rest", sorted(REGISTER_K_PARTIALS))
def test_emulated_objective_partials_at_register_k_are_unchanged(emulator, K,
                                                                 rest):
    """At K <= 32 the objective kernel's partials are bit for bit those of
    the sources before its instances above K = 32 were added."""
    p, t = _objective_problem(K, rest, seed=K + 60)
    partials = emulated_objective(emulator, p, t, rest)[1]
    digest = hashlib.sha256(partials.numpy().tobytes()).hexdigest()[:16]
    assert digest == REGISTER_K_PARTIALS[(K, rest)]


@pytest.mark.parametrize("rest", [False, True])
def test_emulated_objective_is_bitwise_repeatable(emulator, rest):
    """Two launches on one carry: the same partials and objective, bit
    for bit (every sum in a fixed order)."""
    p, t = _objective_problem(20, rest, seed=71)
    first = emulated_objective(emulator, p, t, rest)
    second = emulated_objective(emulator, p, t, rest)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0], second[0])


@pytest.mark.parametrize("rest", [False, True])
def test_emulated_objective_of_a_nan_carry_is_nan(emulator, rest):
    """A NaN in a data column of the carry gives a NaN objective, as the
    plain path's."""
    p, t = _objective_problem(20, rest, seed=73)
    t["carry"][3, p["h"] * p["block"] + 150] = float("nan")
    assert torch.isnan(plain_objective(p, t, rest))
    assert torch.isnan(emulated_objective(emulator, p, t, rest)[0])


@pytest.mark.parametrize("case", ["K", "bands", "offset"])
def test_emulated_objective_entry_refuses(emulator, case):
    """The C entry's own checks (the wrapper's are bypassed here): K > 56,
    more than 32 bands, a band offset past the pad."""
    K = tbcd.OBJECTIVE_KERNEL_MAX_K + 1 if case == "K" else 20
    p, t = _objective_problem(K, False, seed=77)
    offsets, masks = p["offsets"], t["masks"]
    if case == "bands":
        offsets = (offsets * 3)[:33]
        masks = torch.zeros((33, masks.shape[1]), dtype=torch.uint8)
    if case == "offset":
        offsets = (p["h"] * p["block"] + 1,) + offsets[1:]
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tbcd.fused_objective_launch(
            emulator["fused"], 0, t["carry"], t["Xty_t"], t["XtX"], masks,
            t["nnb"], offsets, p["h"], p["block"])


@pytest.mark.parametrize("rest", [False, True])
def test_objective_on_the_cpu_is_the_plain_path(rest):
    """A CPU carry takes the plain path, bit for bit, and launches
    nothing."""
    p, t = _objective_problem(20, rest, seed=79)
    before = tbcd.fused_banded_objective.launches
    kw = dict(rest_touched=t["touched"],
              rest_slot_cols=t["slot_cols"]) if rest else {}
    ref = tbcd.objective_terms_banded_fused_reference(
        t["carry"], t["Xty_t"], t["XtX"], 5e3, p["offsets"], t["masks"], 0.5,
        0.1, p["h"], p["block"], nnb=t["nnb"], **kw)
    assert torch.equal(plain_objective(p, t, rest), ref)
    assert tbcd.fused_banded_objective.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        tbcd.fused_banded_objective(
            t["carry"], t["Xty_t"], t["XtX"], 5e3, t["masks"], t["nnb"], 0.5,
            0.1, p["offsets"], p["h"], p["block"])


# -- the gather tier's neighbour-sum kernel -----------------------------------

def _bits(t: torch.Tensor) -> torch.Tensor:
    """The f32 bit patterns of ``t``: -0.0 and +0.0 differ here, where
    ``torch.equal`` holds them equal."""
    return t.contiguous().view(torch.int32)


def emulated_neighbor_sum(emulator, src_t, nbr_t):
    """The emulated kernel through the wrapper's launch code, into a sums
    buffer that starts as 7.0 everywhere."""
    out = torch.full((src_t.shape[0], nbr_t.shape[1]), 7.0)
    return tbcd.neighbor_sum_launch(emulator["cd"], 0, src_t, nbr_t, out)


def _slot_table(n, D, seed):
    """A (D, n) int32 table, sentinel n: spot j has ``j % (D + 1)``
    neighbours, drawn at random (repeats allowed, as hubs' tables have),
    in its first slots, so every degree 0..D occurs; padding slots hold n."""
    rng = np.random.RandomState(seed)
    table = np.full((D, n), n, dtype=np.int32)
    for j in range(n):
        deg = j % (D + 1)
        table[:deg, j] = rng.randint(0, n, deg)
    return torch.from_numpy(table)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("D", [1, 4, 10])
@pytest.mark.parametrize("K", [1, 6, 20, 34, 96])
def test_emulated_neighbor_sum_is_bitwise_the_plain_loop(emulator, K, D,
                                                        padded):
    """Every K chunking (8, 24, 24 and chunks of 32 with a ragged last
    one at K = 34 and 96), D = 1, 4 and 10 with padding slots, 300 spots
    (a ragged last block): the kernel's sums, from the unpadded carry with
    sentinel n (no copy) or from :func:`with_sentinel`'s buffer, whose
    zero column it reads, are the plain loop's bit for bit."""
    rng = np.random.RandomState(K * 10 + D)
    beta = torch.from_numpy(rng.randn(K, 300).astype(np.float32))
    nbr = _slot_table(300, D, seed=K + D)
    ref = tbcd.neighbor_sum_reference(beta, nbr)
    src = tbcd.with_sentinel(beta) if padded else beta
    got = emulated_neighbor_sum(emulator, src, nbr)
    assert got.shape == (K, 300)
    assert torch.equal(_bits(got), _bits(ref))


def test_emulated_neighbor_sum_keeps_the_sign_of_zero(emulator):
    """A sum of -0.0s stays -0.0 where every slot is a neighbour, and a
    padding slot's +0.0 turns it into +0.0, as in the plain loop."""
    nbr = _slot_table(64, 4, seed=3)
    beta = torch.full((6, 64), -0.0)
    beta[:, ::3] = 1.5
    ref = tbcd.neighbor_sum_reference(beta, nbr)
    got = emulated_neighbor_sum(emulator, beta, nbr)
    assert torch.equal(_bits(got), _bits(ref))
    negative_zero = _bits(torch.tensor(-0.0)).item()
    assert (_bits(ref) == negative_zero).any()
    assert (_bits(ref) == 0).any()


@pytest.mark.parametrize("index", [41, 1000, -3])
def test_neighbor_sum_reference_refuses_an_index_off_the_source(index):
    """The plain path's index rule is the kernel's precondition: every
    index lies in [0, n_cols], n_cols reading +0.0; any other raises."""
    beta = torch.rand(8, 40)
    nbr = _slot_table(40, 3, seed=6)
    assert (nbr == 40).any()
    tbcd.neighbor_sum_reference(beta, nbr)
    nbr[0, 7] = index
    with pytest.raises((IndexError, RuntimeError)):
        tbcd.neighbor_sum_reference(beta, nbr)


@pytest.mark.parametrize("K", [6, 20, 34])
def test_emulated_overflow_sums_are_bitwise_the_plain_path(emulator, K,
                                                            monkeypatch):
    """A degree-capped table (cap 4) and its overflow hubs' (S, H) int32
    table (:func:`overflow_table`): the kernel's hub sums from the
    unpadded carry are the plain loop's bit for bit, and so is
    :func:`gather_neighbor_sums` (table, then hubs) taking the kernel's
    route."""
    from flashdeconv_tpu_torch.utils.graph import adjacency_to_padded_capped

    p = gather_problem(n=400, n_types=K, seed=K + 80)
    A = build_knn_graph(p["coords"], k=8)
    nbr, _, ov_src, ov_dst = adjacency_to_padded_capped(A, max_degree=4)
    assert ov_src.size
    rows, table = tbcd.overflow_table(ov_src, ov_dst, 400)
    beta = torch.from_numpy(p["beta_t"])
    nbr_t = torch.from_numpy(np.ascontiguousarray(nbr.T, dtype=np.int32))
    overflow = (torch.from_numpy(rows),
                torch.from_numpy(table.astype(np.int32)))
    hubs = emulated_neighbor_sum(emulator, beta, overflow[1])
    assert torch.equal(_bits(hubs), _bits(tbcd.overflow_sum(
        beta, overflow[1])))
    ref = tbcd.gather_neighbor_sums(beta, nbr_t, overflow)
    monkeypatch.setattr(tbcd, "neighbor_sum_kernel_takes", lambda t: True)
    monkeypatch.setattr(tbcd, "neighbor_sum", lambda src, nbr_: (
        emulated_neighbor_sum(emulator, src, nbr_)))
    got = tbcd.gather_neighbor_sums(beta, nbr_t, overflow)
    assert torch.equal(_bits(got), _bits(ref))


def test_emulated_neighbor_sums_give_the_plain_gather_solve(emulator,
                                                            monkeypatch):
    """A whole gather-tier solve loop (``bcd_iterate``, K = 20) whose
    neighbour sums take the kernel's route, from the unpadded carry: the
    same beta bits, sweeps and stopping ratio as the plain loop's, and one
    kernel call a sweep and one for the objective."""
    p = gather_problem(n=500, n_types=20, seed=91)
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "coords"}
    args = (t["Xty_t"], t["XtX"], t["nbr_t"], t["nnb"], 0.5, 0.05, 1e-4, 40)
    ref, it_r, rel_r = tbcd.bcd_iterate(t["beta_t"].clone(), *args)
    obj_r = tbcd.objective_terms(ref, t["Xty_t"], t["XtX"], 5e3, t["nbr_t"],
                                 t["nnb"], 0.5, 0.05)
    calls = []

    def kernel_route(src, nbr_):
        calls.append(src.shape)
        return emulated_neighbor_sum(emulator, src, nbr_)

    monkeypatch.setattr(tbcd, "neighbor_sum_kernel_takes", lambda t: True)
    monkeypatch.setattr(tbcd, "neighbor_sum", kernel_route)
    got, it_g, rel_g = tbcd.bcd_iterate(t["beta_t"].clone(), *args)
    obj_g = tbcd.objective_terms(got, t["Xty_t"], t["XtX"], 5e3,
                                 t["nbr_t"], t["nnb"], 0.5, 0.05)
    assert it_r > 2 and (it_g, rel_g) == (it_r, rel_r)
    assert torch.equal(_bits(got), _bits(ref))
    assert torch.equal(obj_g, obj_r)
    assert calls == [(20, 500)] * (it_g + 1)


@pytest.mark.parametrize("case", ["f64 source", "int64 table", "f64 out",
                                  "strided source", "strided table",
                                  "out shape", "no slot", "1-d table"])
def test_neighbor_sum_launch_refuses(emulator, case):
    """The wrapper's checks before the C entry: f32 source and sums, an
    int32 (D, n) table with D >= 1, every operand contiguous, the sums
    (K, n)."""
    beta = torch.rand(6, 50)
    nbr = _slot_table(50, 3, seed=2)
    out = torch.empty(6, 50)
    if case == "f64 source":
        beta = beta.double()
    if case == "int64 table":
        nbr = nbr.long()
    if case == "f64 out":
        out = out.double()
    if case == "strided source":
        beta = torch.rand(50, 6).T
    if case == "strided table":
        nbr = _slot_table(100, 3, seed=2)[:, ::2]
    if case == "out shape":
        out = torch.empty(6, 51)
    if case == "no slot":
        nbr = nbr[:0]
    if case == "1-d table":
        nbr = nbr[0]
    with pytest.raises(ValueError):
        tbcd.neighbor_sum_launch(emulator["cd"], 0, beta, nbr, out)


@pytest.mark.parametrize("case", ["K", "D", "n", "n_cols", "n_cols int32"])
def test_emulated_neighbor_sum_entry_refuses(emulator, case):
    """The C entry's own checks (the wrapper's are bypassed here): K, D, n
    and n_cols below 1, and n_cols past the table's int32 range, are
    refused with cudaErrorInvalidValue, launching nothing."""
    beta = torch.rand(6, 50)
    nbr = _slot_table(50, 3, seed=2)
    out = torch.full((6, 50), 7.0)
    dims = dict(n_cols=50, D=3, n=50, K=6)
    dims.update({"K": {"K": 0}, "D": {"D": 0}, "n": {"n": 0},
                 "n_cols": {"n_cols": 0},
                 "n_cols int32": {"n_cols": 1 << 31}}[case])
    lib = emulator["cd"]
    assert lib.fdt_neighbor_sum(beta.data_ptr(), dims["n_cols"],
                                nbr.data_ptr(), dims["D"], dims["n"],
                                dims["K"], out.data_ptr(), None) == 1
    assert (out == 7.0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_neighbor_sum_on_the_cpu_is_the_plain_loop(dtype):
    """A CPU carry, f32 or f64, runs the plain loop bit for bit and
    launches nothing, from the carry or from a buffer with its own zero
    column; so does an int64 table, which the kernel's route refuses."""
    beta = torch.rand(6, 50, dtype=dtype)
    nbr = _slot_table(50, 3, seed=4)
    before = tbcd.neighbor_sum.launches
    ref = tbcd.neighbor_sum_reference(beta, nbr)
    assert not tbcd.neighbor_sum_kernel_takes(beta)
    assert torch.equal(tbcd.neighbor_sum(beta, nbr), ref)
    assert torch.equal(tbcd.neighbor_sum(tbcd.with_sentinel(beta), nbr), ref)
    assert torch.equal(tbcd.gather_neighbor_sums(beta, nbr), ref)
    assert torch.equal(tbcd.gather_neighbor_sums(beta, nbr.long()), ref)
    assert tbcd.neighbor_sum.launches == before
    assert not tbcd.neighbor_sum.card_launches
