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
bit for bit. Bounds as on the card (tests/test_torch_kernels.py): atol
5e-5 / rtol 1e-4 against the plain versions, rtol 1e-4 on the statistics,
fused == unfused banded bitwise, a split sweep == the whole sweep bitwise.
The objective kernel of ``fused_banded_sweep.cu`` runs through the same
library (its C entry and the wrapper's launch and reduction code) within
rtol 1e-5 of the plain path, each of its five sums within rtol 1e-6 of
the plain path's, bitwise against itself; the C entry's refusals are run
too, and a CPU carry is held to the plain path.
"""

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
    libs = {}
    for name, flag, kernel in (("fused", "-DFUSED", "fused_banded_sweep"),
                               ("cd", "-UFUSED", "cd_block_sweep")):
        so = out / f"emu_{name}.so"
        subprocess.run(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", flag, f"-I{out}", "-o", str(so),
             str(EMULATION / "emulate.cpp")],
            check=True, capture_output=True, text=True,
        )
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


@pytest.mark.parametrize("K", [20, 24, 33, 48, 64, 65, 80, 96, 129, 255,
                               256])
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


@pytest.mark.parametrize("K", [20, 24, 33, 48, 64, 128, 256])
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


@pytest.mark.parametrize("K", [6, 20, 24, 33, 48, 64, 96, 256])
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


@pytest.mark.parametrize("K", [20, 48, 128])
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
                                      (128, 61_952), (256, 111_104)])
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
