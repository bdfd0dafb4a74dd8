"""Golden (oracle) models, host-side.

Parity with the reference's two oracles:

- ``std::sort`` wrapper (``src/CRadixSortTask.cpp:31-43``) → :func:`oracle_sort`
  (``np.sort``) and :func:`oracle_argsort` (stable) for key-value checks.

- ``RadixSortCPU<T>::sort`` (``src/CRadixSortCPU.h:29-123``) → :func:`cpu_radix_sort`,
  a scalar-semantics LSD counting sort.  The reference has a quirk: its digit
  base is ``NUM_BINS = TOTALBITS / _NUM_BITS_PER_RADIX`` (= 8 for 32-bit keys),
  *not* ``_RADIX`` (= 16), with digits via ``(value / exp) % NUM_BINS`` and a
  data-dependent pass count ``ceil(log(max)/log(NUM_BINS))``
  (SURVEY.md §2 #10).  We keep the base-8 behavior (it still sorts correctly)
  but implement each counting pass with vectorized numpy so large-n golden
  runs are practical.  Signed keys are biased by subtracting the type minimum,
  exactly as the reference does.

Both oracles are used exactly like the reference's ValidateResults
(``src/CRadixSortTask.cpp:224-252``): bit-exact comparison over the first n
elements, no tolerance.
"""

from __future__ import annotations

import numpy as np

from . import dtypes


def oracle_sort(keys: np.ndarray) -> np.ndarray:
    """Ground truth, the ``std::sort`` equivalent."""
    return np.sort(keys, kind="stable")


def oracle_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable permutation oracle for key-value sorts."""
    return np.argsort(keys, kind="stable")


def cpu_radix_sort(keys: np.ndarray, base: int | None = None) -> np.ndarray:
    """Scalar-semantics LSD counting sort, the reference golden model.

    ``base`` defaults to the reference's quirky ``TOTALBITS / BITS_PER_RADIX``
    (8 for 32-bit, 16 for 64-bit keys at 4 bits/radix — src/CRadixSortCPU.h:57).
    """
    d = np.dtype(keys.dtype)
    if d.kind == "f":
        # Reference had no float path; use the order-preserving bit transform.
        u = dtypes.np_to_sortable_unsigned(keys).astype(np.uint64)
        bias_back = lambda s: dtypes.np_from_sortable_unsigned(
            s.astype(dtypes.unsigned_container(d)), d
        )
    else:
        total_bits = d.itemsize * 8
        # Bias signed by subtracting numeric_limits::min (CRadixSortCPU.h:43-49).
        if d.kind == "i":
            u = (keys.astype(np.int64) - np.iinfo(d).min).astype(np.uint64)
        else:
            u = keys.astype(np.uint64)
        bias_back = lambda s: (
            (s.astype(np.int64) + np.iinfo(d).min).astype(d)
            if d.kind == "i"
            else s.astype(d)
        )
    if base is None:
        total_bits = d.itemsize * 8
        base = max(2, total_bits // 4)  # reference NUM_BINS quirk

    n = u.size
    if n == 0:
        return keys.copy()
    # Pass count from the data maximum (CRadixSortCPU.h:57-72).
    mx = int(u.max())
    work = u.copy()
    exp = 1
    while mx // exp > 0:
        digit = (work // exp) % base
        # counting sort: count → prefix → backward stable scatter
        # (CRadixSortCPU.h:81-122), vectorized.
        order = np.argsort(digit, kind="stable")
        work = work[order]
        exp *= base
        if exp > mx:
            break
    return bias_back(work)


def validate_bit_exact(result: np.ndarray, expected: np.ndarray, n: int) -> bool:
    """memcmp-style check over the first ``n`` elements
    (src/CRadixSortTask.cpp:229-249)."""
    a = np.asarray(result)[:n]
    b = np.asarray(expected)[:n]
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return bool(np.array_equal(a.view(np.uint8), b.view(np.uint8)))
