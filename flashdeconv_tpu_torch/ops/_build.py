"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library of its own with a plain C interface, all sources at once, one
``nvcc`` process each. A library is named by its source and a hash of every
file under ``csrc/`` (so an edit to a shared header rebuilds every kernel)
and of the flags, lives under ``ops/build/`` (git-ignored), and is loaded
with :mod:`ctypes`. A source that does not include PyTorch's headers builds
in seconds, where a ``torch.utils.cpp_extension`` build takes minutes. Each
compile writes to a temporary name and renames, so concurrent processes
never load a half-written library. There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

CSRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").is_file():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of flashdeconv_tpu_torch are built from source at "
        "first use"
    )


def _digest() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC_DIR.rglob("*") if p.is_file()):
        digest.update(str(path.relative_to(CSRC_DIR)).encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def _compile(nvcc: str, src: Path, so: Path) -> None:
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)


def build() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` whose library of the current hash does
    not exist yet, in parallel; return ``{kernel name: library path}``.
    The compiler's ``-Xptxas -v`` report (registers, spills, shared memory
    per kernel) is kept beside each library as ``.log``."""
    digest = _digest()
    libs = {src.stem: (src, BUILD_DIR / f"{src.stem}-{digest}.so")
            for src in sorted(CSRC_DIR.glob("*.cu"))}
    todo = [(src, so) for src, so in libs.values() if not so.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with concurrent.futures.ThreadPoolExecutor(len(todo)) as pool:
            for fut in [pool.submit(_compile, nvcc, src, so)
                        for src, so in todo]:
                fut.result()
    return {name: so for name, (_, so) in libs.items()}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    if name == "fused_banded_sweep":
        lib.fdt_fused_banded_sweep.argtypes = [
            p, ll, ll, p, ll, ll, p, p, p, p, ll, ll, p,
            ctypes.POINTER(ctypes.c_int), i, i, ll, ll, i, f, f, p, p,
        ]
        lib.fdt_fused_banded_sweep.restype = i
        lib.fdt_fused_banded_sweep_blocks.argtypes = [ll, i]
        lib.fdt_fused_banded_sweep_blocks.restype = ll
        lib.fdt_fused_banded_objective.argtypes = [
            p, ll, p, p, p, p, ll, p, ctypes.POINTER(ctypes.c_int), i, i, ll,
            p, p,
        ]
        lib.fdt_fused_banded_objective.restype = i
        lib.fdt_fused_banded_objective_blocks.argtypes = [ll]
        lib.fdt_fused_banded_objective_blocks.restype = ll
    elif name == "cd_block_sweep":
        lib.fdt_cd_block_sweep.argtypes = [
            p, p, p, p, p, p, i, ll, f, f, p, p,
        ]
        lib.fdt_cd_block_sweep.restype = i
        lib.fdt_cd_block_sweep_blocks.argtypes = [ll, i]
        lib.fdt_cd_block_sweep_blocks.restype = ll
        lib.fdt_neighbor_sum.argtypes = [p, ll, p, i, ll, i, p, p]
        lib.fdt_neighbor_sum.restype = i
    elif name == "countsketch_project":
        lib.fdt_countsketch_project.argtypes = [p, ll, i, p, p, p, i, p, p]
        lib.fdt_countsketch_project.restype = i
        lib.fdt_countsketch_gene_tile.argtypes = []
        lib.fdt_countsketch_gene_tile.restype = i
    else:
        raise KeyError(f"no kernel {name!r} in {CSRC_DIR}")
    lib.fdt_error_string.argtypes = [i]
    lib.fdt_error_string.restype = ctypes.c_char_p
    # The passes' queries (a library built from older sources may lack
    # some: the register forms' before the K <= 32 register pass, the
    # panel pass's before the register-tiled one).
    queries = {"fdt_panel_pass_smem_bytes": ([i], ll),
               "fdt_fused_banded_sweep_panel_occupancy": ([i, i], i),
               "fdt_cd_block_sweep_panel_occupancy": ([i], i),
               "fdt_fused_banded_sweep_register_occupancy": ([i, i], i),
               "fdt_cd_block_sweep_register_occupancy": ([i], i)}
    for fn, (args, res) in queries.items():
        if name != "countsketch_project" and hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = res


@contextlib.contextmanager
def launch_stream(*operands: Optional[torch.Tensor]) -> Iterator[int]:
    """The ``cudaStream_t`` (an int) a kernel on ``operands`` launches on:
    the current stream of the card that holds them, with that card made
    current for the block. CUDA refuses a launch to a stream of a card
    other than the current one, and ``cudaFuncSetAttribute`` applies to
    the current card, so every launch goes through here. None operands
    (an optional input left out) are skipped; operands on more than one
    device raise. When the card is already current (one card, or inside
    ``Mesh.on``) nothing is switched.
    """
    devices = {t.device for t in operands if t is not None}
    if len(devices) != 1:
        raise ValueError(f"a kernel's operands must lie on one card, got "
                         f"{sorted(str(d) for d in devices)}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"a kernel launches on a CUDA device, got {device}")
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (the stem of its ``.cu``), with
    ``argtypes``/``restype`` declared. The first call builds every kernel."""
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        _declare(name, lib)
        _libs[name] = lib
    return _libs[name]
