"""The CUDA sweep kernels' sources, run on the CPU, against their plain
PyTorch versions.

There is no CUDA compiler or card on a CPU machine, so
``tests/cuda_emulation/`` compiles a copy of each sweep kernel's source
(``fused_banded_sweep.cu``, ``cd_block_sweep.cu`` and their headers) with
g++ against host stand-ins for the CUDA names: one std::thread per CUDA
thread, a barrier for ``__syncthreads``, blocks one after another. The
copy differs from the source only where a host compiler must: dynamic
shared memory points at a static buffer, each ``<<<...>>>`` launch becomes
a call of the emulator's block loop, and the PTX ``max.NaN.f32`` becomes a
NaN-propagating ``fmax``. The library exports the sources' own C entry
points, driven by the wrappers' own launch code
(``ops/bcd.fused_sweep_launch`` / ``cd_sweep_launch``), so this runs the
C entries' range checks and dispatch and the kernels' indexing, tiling,
synchronisation and arithmetic — the register pass at K <= 64 and the
panel pass above, the whole sweep and its sub-range form, each with and
without the rest stream's ``ns_rest`` input — at small sizes. Bounds as on the card (tests/test_torch_kernels.py): atol 5e-5 /
rtol 1e-4 against the plain versions, rtol 1e-4 on the statistics, fused
== unfused banded bitwise, a split sweep == the whole sweep bitwise.
"""

import ctypes
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
    "gs_pass.cuh": [(
        'asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));',
        "m = (a != a || b != b) ? NAN : std::fmax(a, b);",
    )],
    "fused_banded_sweep.cu": [
        ("extern __shared__ float smem[];",
         "float* smem = reinterpret_cast<float*>(fdt_emu_smem);"),
        ("extern __shared__ float4 smem4[];", "float4* smem4 = fdt_emu_smem;"),
    ],
    "cd_block_sweep.cu": [
        ("extern __shared__ float xtx_s[];",
         "float* xtx_s = reinterpret_cast<float*>(fdt_emu_smem);"),
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
            r"fdt_emu_launch(blocks, [&] { \1(\2); });", text)
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


@pytest.mark.parametrize("K", [20, 65, 96, 256])
def test_emulated_cd_kernel_matches_plain_version(emulator, K):
    """100 spots: a ragged last block at every K."""
    p = gather_problem(n=100, n_types=K, seed=K)
    t = {k: torch.from_numpy(v) for k, v in p.items() if k != "coords"}
    ns = tbcd.neighbor_sum(tbcd.with_sentinel(t["beta_t"]), t["nbr_t"])
    inv = tbcd.gs_inv_den(t["XtX"], t["nnb"], 0.5)
    args = (t["beta_t"], t["Xty_t"], t["XtX"], ns, inv, 0.5, 0.1)
    got = emulated_cd(emulator, *args)
    ref = tbcd.coordinate_descent_block_reference(*args)
    _close(got, ref)
    assert (got[0] >= 0).all()


@pytest.mark.parametrize("K", [20, 65, 96, 256])
def test_emulated_fused_kernel_matches_plain_and_unfused(emulator, K):
    """A 20 x 20 grid with a 40-spot pad, which splits a 32-spot tile of
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


@pytest.mark.parametrize("K", [20, 128])
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


@pytest.mark.parametrize("K", [6, 20, 96])
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


@pytest.mark.parametrize("K", [20, 128])
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
