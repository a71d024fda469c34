"""The CUDA sweep kernels' sources, run on the CPU, against their plain
PyTorch versions.

There is no CUDA compiler or card on a CPU machine, so
``tests/cuda_emulation/`` compiles a copy of each sweep kernel's source
(``fused_banded_sweep.cu``, ``cd_block_sweep.cu`` and their headers) with
g++ against host stand-ins for the CUDA names: one std::thread per CUDA
thread, a barrier for ``__syncthreads``, blocks one after another. The
copy differs from the source only where a host compiler must: dynamic
shared memory points at a static buffer, the ``<<<...>>>`` launches are
dropped (the emulator launches), and the PTX ``max.NaN.f32`` becomes a
NaN-propagating ``fmax``. That runs the kernels' own indexing, tiling,
synchronisation and arithmetic — the register pass at K <= 64 and the
panel pass above — at small sizes. Bounds as on the card
(tests/test_torch_kernels.py): atol 5e-5 / rtol 1e-4 against the plain
versions, rtol 1e-4 on the statistics, fused == unfused banded bitwise.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from flashdeconv_tpu_torch.ops import bcd as tbcd
from torch_problems import fused_problem, gather_problem

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
LAUNCH = "<<<blocks, FDT_THREADS, smem, "


def _host_copy(src: Path, dst: Path) -> None:
    text = src.read_text()
    for old, new in HOST_EDITS.get(src.name, []):
        assert old in text, f"{src.name} no longer has {old!r}"
        text = text.replace(old, new)
    if src.suffix == ".cu":
        n = text.count(LAUNCH)
        assert n >= 2, f"{src.name}: expected its launches"
        head, *rest = text.split(LAUNCH)
        text = head + "".join(r.split(">>>", 1)[1] for r in rest)
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
    for name, flag in (("fused", "-DFUSED"), ("cd", "-UFUSED")):
        so = out / f"emu_{name}.so"
        subprocess.run(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", flag, f"-I{out}", "-o", str(so),
             str(EMULATION / "emulate.cpp")],
            check=True, capture_output=True, text=True,
        )
        libs[name] = ctypes.CDLL(str(so))
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    libs["fused"].emu_fused_banded_sweep.argtypes = [
        p, p, p, p, p, p, p, i, i, ll, ll, ll, f, f, p]
    libs["fused"].emu_fused_banded_sweep.restype = ll
    libs["cd"].emu_cd_block_sweep.argtypes = [p, p, p, p, p, p, i, ll, f, f,
                                              p]
    libs["cd"].emu_cd_block_sweep.restype = ll
    return libs


def _ptr(a: np.ndarray):
    assert a.flags.c_contiguous
    return a.ctypes.data


def _stats(partials: np.ndarray):
    return [torch.tensor(np.max(row) if not np.isnan(row).any()
                         else np.nan) for row in partials]


def emulated_cd(emulator, beta_t, Xty_t, XtX, ns_t, inv_den_t, lam, rho):
    a = [np.ascontiguousarray(t.numpy()) for t in
         (beta_t, Xty_t, ns_t, inv_den_t, XtX)]
    K, n = a[0].shape
    out = np.full_like(a[0], 7.0)
    partials = np.full((2, n), -1.0, np.float32)  # more than the blocks
    blocks = emulator["cd"].emu_cd_block_sweep(
        _ptr(a[0]), _ptr(out), _ptr(a[1]), _ptr(a[2]), _ptr(a[3]),
        _ptr(a[4]), K, n, tbcd.f32(lam), tbcd.f32(rho), _ptr(partials))
    flat = partials.reshape(-1)[:2 * blocks].reshape(2, blocks)
    return (torch.from_numpy(out), *_stats(flat))


def emulated_fused(emulator, carry, Xty_t, XtX, masks, inv_den_t, lam, rho,
                   offsets, h, block):
    a = [np.ascontiguousarray(t.numpy()) for t in
         (carry, Xty_t, masks, inv_den_t, XtX)]
    K, n_ext = a[0].shape
    pad = h * block
    offs = np.asarray(offsets, np.int32)
    out = np.full_like(a[0], 7.0)
    partials = np.full((2, n_ext), -1.0, np.float32)
    blocks = emulator["fused"].emu_fused_banded_sweep(
        _ptr(a[0]), _ptr(out), _ptr(a[1]), _ptr(a[2]), _ptr(a[3]),
        _ptr(a[4]), _ptr(offs), len(offsets), K, n_ext, pad, n_ext - 2 * pad,
        tbcd.f32(lam), tbcd.f32(rho), _ptr(partials))
    flat = partials.reshape(-1)[:2 * blocks].reshape(2, blocks)
    return (torch.from_numpy(out), *_stats(flat))


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
