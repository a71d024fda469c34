"""Build the port's CUDA sources at first use and load them with ctypes.

``csrc/*.cu`` are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, named by a hash of the sources and the
flags, under ``ops/build/`` (git-ignored), and loaded with :mod:`ctypes`.
A source that does not include PyTorch's headers builds in seconds, where
a ``torch.utils.cpp_extension`` build takes minutes. The compile writes to
a temporary name and renames, so concurrent processes never load a
half-written library. There is no fallback: a missing ``nvcc`` or a failed
build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None


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


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists;
    return its path. The compiler's ``-Xptxas -v`` report (registers,
    spills, shared memory per kernel) is kept beside it as ``.log``."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"fdt_kernels-{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The built library, with ``argtypes``/``restype`` declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.fdt_fused_banded_sweep.argtypes = [
            p, p, p, p, p, p, ctypes.POINTER(ctypes.c_int), i, i, ll, ll, ll,
            f, f, p, p,
        ]
        lib.fdt_fused_banded_sweep.restype = ctypes.c_int
        lib.fdt_fused_banded_sweep_blocks.argtypes = [ll]
        lib.fdt_fused_banded_sweep_blocks.restype = ll
        lib.fdt_error_string.argtypes = [ctypes.c_int]
        lib.fdt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
