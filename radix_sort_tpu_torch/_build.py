"""Build and load the CUDA kernels in ``csrc/`` at first use.

``nvcc`` compiles the sources of ``csrc/`` for ``sm_90a`` into one shared
library with a plain C interface under ``build/kernels/`` at the root of
the checkout (git-ignored), named by a hash of the sources and the flags, so
an edited source builds anew and an unchanged one is reused.  The library
is loaded with ctypes; every entry point takes device pointers and the CUDA
stream as ``c_void_p`` and returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .status import EngineError, OperationStatus

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("radix.cu", "merge.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "rst_max_planes": ([], _I),
    "rst_scan_scratch_bytes": ([_LL], _LL),
    "rst_digit_histogram": ([_P, _LL, _I, _I, _I, _I, _P, _LL, _LL, _P], _I),
    "rst_exclusive_scan": ([_P, _LL, _P, _P, _LL, _P], _I),
    "rst_rank_scatter": ([_P, _LL, _I, _I, _I, _I, _P,
                          ctypes.POINTER(_P), ctypes.POINTER(_P), _I, _P, _P],
                         _I),
    "rst_merge_tile": ([], _I),
    "rst_tile_sort": ([_P, _LL, _P, _P], _I),
    "rst_merge_level": ([_P, _LL, _I, _P, _P, _P, _P, _P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise EngineError(OperationStatus.COMPILATION_FAILED,
                      "nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    """Where the built library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"librst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Raises EngineError with the compiler's output if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(_CSRC / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise EngineError(OperationStatus.COMPILATION_FAILED,
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    handle = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise EngineError(OperationStatus.CALCULATION_FAILED,
                          f"{what}: CUDA error {status}")
