"""ctypes bridge to the native C++ host baselines (native/host_baseline.cpp).

Port of ``radix_sort_tpu/utils/native_baseline.py``, loading the same
shared library, ``native/libhostbaseline.so`` at the root of the checkout
(``make -C native``): ``std::sort`` and a scalar LSD radix sort, the
reference's two host baselines (``src/CRadixSortTask.cpp:172-222``) whose
times fill the ``avgTotalSTLCPU`` / ``avgTotalRDXCPU`` CSV columns.

Raises ImportError when the library has not been built; the harness then
times ``golden.cpu_radix_sort`` instead.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from .. import dtypes

LIBRARY = (Path(__file__).resolve().parent.parent.parent / "native"
           / "libhostbaseline.so")
_U32P = ctypes.POINTER(ctypes.c_uint32)
_U64P = ctypes.POINTER(ctypes.c_uint64)


@functools.cache
def _load() -> ctypes.CDLL:
    if not LIBRARY.exists():
        raise ImportError(f"native baseline library not built: {LIBRARY} "
                          "(run `make -C native`)")
    lib = ctypes.CDLL(str(LIBRARY))
    for name in ("std_sort_u32", "radix_sort_u32"):
        getattr(lib, name).argtypes = [_U32P, ctypes.c_size_t]
    for name in ("std_sort_u64", "radix_sort_u64"):
        getattr(lib, name).argtypes = [_U64P, ctypes.c_size_t]
    lib.radix_sort_kv_u32.argtypes = [_U32P, _U32P, ctypes.c_size_t]
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except ImportError:
        return False


def _run(prefix: str, keys: np.ndarray) -> np.ndarray:
    """In-C++ ``{prefix}_u32/_u64`` on a copy of the biased unsigned image;
    returns sorted keys in the original dtype."""
    lib = _load()
    u = dtypes.np_to_sortable_unsigned(np.ascontiguousarray(keys)).copy()
    if u.dtype.itemsize == 4:
        getattr(lib, f"{prefix}_u32")(u.ctypes.data_as(_U32P), u.size)
    elif u.dtype.itemsize == 8:
        getattr(lib, f"{prefix}_u64")(u.ctypes.data_as(_U64P), u.size)
    else:
        raise TypeError(f"unsupported itemsize {u.dtype.itemsize}")
    return dtypes.np_from_sortable_unsigned(u, keys.dtype)


def std_sort(keys: np.ndarray) -> np.ndarray:
    """``std::sort`` on the biased unsigned image."""
    return _run("std_sort", keys)


def radix_sort(keys: np.ndarray) -> np.ndarray:
    """Native scalar LSD radix sort (the RadixSortCPU-equivalent baseline)."""
    return _run("radix_sort", keys)


def radix_sort_kv_u32(keys: np.ndarray, vals: np.ndarray):
    lib = _load()
    u = dtypes.np_to_sortable_unsigned(np.ascontiguousarray(keys)).copy()
    v = np.ascontiguousarray(vals, dtype=np.uint32).copy()
    lib.radix_sort_kv_u32(u.ctypes.data_as(_U32P), v.ctypes.data_as(_U32P),
                          u.size)
    return dtypes.np_from_sortable_unsigned(u, keys.dtype), v


def radix_sort_fn(keys: np.ndarray):
    """A zero-arg callable timing one native radix sort of ``keys``; raises
    ImportError now if the library is not built."""
    _load()
    return lambda: radix_sort(keys)
