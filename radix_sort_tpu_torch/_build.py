"""Build and load the CUDA kernels in ``csrc/`` at first use.

``nvcc`` compiles each source of ``csrc/`` for ``sm_90a``, one process a
source, all started together, and links the objects into one shared library
with a plain C interface under ``build/kernels/`` at the root of the
checkout (git-ignored), named by a hash of the sources, their headers and
the flags, so an edited source builds anew and an unchanged one is reused.
The library is loaded with ctypes; every entry point takes device pointers
and the CUDA stream as ``c_void_p`` and returns ``cudaGetLastError()``.

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
SOURCES = ("radix.cu", "radix_wide.cu", "merge.cu")
HEADERS = ("radix_pass.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PP = ctypes.POINTER(_P)  # a host array of device pointers
_PI = ctypes.POINTER(_I)  # a host array of ints
_SIGNATURES = {
    "rst_max_planes": ([], _I),
    "rst_scan_scratch_bytes": ([_LL], _LL),
    "rst_digit_histogram": ([_P, _LL, _I, _I, _I, _I, _P, _LL, _LL, _P], _I),
    "rst_exclusive_scan": ([_P, _LL, _P, _P, _LL, _P], _I),
    "rst_rank_scatter": ([_PP, _LL, _I, _I, _I, _I, _I, _I, _P, _PP, _PP,
                          _PP, _I, _PI, _P, _P, _I, _I, _I, _PP, _P], _I),
    "rst_pass_histograms": ([_P, _I, _P, _I, _LL, _I, _I, _I, _P, _P], _I),
    "rst_onesweep_scratch_bytes": ([_LL, _I, _I], _LL),
    "rst_zero": ([_P, _LL, _P], _I),
    "rst_onesweep_pass": ([_PP, _LL, _I, _I, _I, _I, _I, _I, _P, _P, _LL,
                           _PP, _PP, _PP, _I, _PI, _P, _P, _P, _I, _I, _I,
                           _PP, _P], _I),
    "rst_sort_workspace_bytes": ([_LL, _I, _I, _I, _I], _LL),
    "rst_sort_planes": ([_LL, _I, _I, _I, _I, _I, _PP, _I, _I, _PP, _PP,
                         _PP, _I, _PI, _I, _P, _LL, _P, _PI], _I),
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
    for name in SOURCES + HEADERS:
        h.update((_CSRC / name).read_bytes())
    return BUILD_DIR / f"librst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    Raises EngineError with the compiler's output if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [out.with_suffix(f".{os.getpid()}.{name}.o") for name in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
            for name, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    try:
        for cmd, p, log in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise EngineError(OperationStatus.COMPILATION_FAILED,
                                  f"{' '.join(cmd)}\n{log}")
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise EngineError(OperationStatus.COMPILATION_FAILED,
                              f"{' '.join(link)}\n{res.stdout}\n"
                              f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Each entry point is
    looked up and bound here, once: ``lib().rst_x`` is then an attribute
    of the handle."""
    handle = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return handle


@functools.cache
def max_planes() -> int:
    """``rst_max_planes()``: the planes one pass-kernel launch moves."""
    return lib().rst_max_planes()


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise EngineError(OperationStatus.CALCULATION_FAILED,
                          f"{what}: CUDA error {status}")
