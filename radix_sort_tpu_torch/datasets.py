"""Benchmark/test dataset generators.

Behavioral port of the reference's five distributions
(``src/Dataset.h:21-169``): Zeros, RandomDistributed (uniform over the full
type range, planted global min/max at the ends, nondeterministic seed by
default), Random (mt19937 with a fixed seed — deterministic), Range (iota
from the type's minimum), InvertedRange (reversed iota).  Explicitly
instantiated there for i32/i64/u32/u64; here any registered key dtype works.

These are *generators of numpy arrays* — host-side, like the reference's —
and are moved to the device by the caller (``dtypes.tensor_from_numpy``).
The same code as ``radix_sort_tpu/datasets.py``: numpy only, so the two
packages make byte-identical data from one seed.
"""

from __future__ import annotations

import numpy as np

from . import dtypes

# The reference seeds its deterministic mt19937 from the string
# "Random Test Seed" (src/Dataset.h:113-115).  We derive a stable integer
# seed from the same string.
_FIXED_SEED_STRING = b"Random Test Seed"
FIXED_SEED = int.from_bytes(_FIXED_SEED_STRING[:8], "little") & 0xFFFFFFFF


class Dataset:
    """Base generator: subclasses implement ``_fill``; parity with the
    reference's ``Dataset<T>`` + ``name()`` contract (src/Dataset.h:21-40)."""

    name: str = "base"

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def generate(self, n: int) -> np.ndarray:
        if n < 0:
            raise ValueError("n must be non-negative")
        return self._fill(n)

    def _fill(self, n: int) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError


class Zeros(Dataset):
    """All zeros (src/Dataset.h Zeros) — the degenerate anti-case where the
    reference's GPU advantage collapsed (doc/doc.tex:113)."""

    name = "Zeros"

    def _fill(self, n):
        return np.zeros(n, dtype=self.dtype)


class RandomDistributed(Dataset):
    """Uniform over the full type range, min and max planted at the ends
    (src/Dataset.h:95-106).  Time-seeded there; seedable here (None = entropy
    seed) so CI can pin it."""

    name = "RandomDistributed"

    def __init__(self, dtype, seed: int | None = None):
        super().__init__(dtype)
        self.seed = seed

    def _fill(self, n):
        rng = np.random.Generator(np.random.MT19937(self.seed))
        d = self.dtype
        if d.kind == "f":
            out = rng.uniform(-1e9, 1e9, size=n).astype(d)
            lo, hi = d.type(-np.inf), d.type(np.inf)
        else:
            info = np.iinfo(d)
            u = dtypes.unsigned_container(d)
            raw = rng.integers(0, 1 << (d.itemsize * 8), size=n, dtype=u)
            out = raw.view(d) if d.kind == "i" else raw.astype(d)
            lo, hi = d.type(info.min), d.type(info.max)
        if n >= 1:
            out[0] = lo
        if n >= 2:
            out[-1] = hi
        return out


class Random(Dataset):
    """Raw mt19937 draws with the fixed seed — deterministic
    (src/Dataset.h:113-119).  mt19937 yields 32-bit words, so (as in the
    reference, where words are assigned to T) 64-bit keys still get values
    < 2^32."""

    name = "Random"

    def _fill(self, n):
        rng = np.random.Generator(np.random.MT19937(FIXED_SEED))
        raw = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
        d = self.dtype
        if d.kind == "f":
            return raw.astype(d)
        return raw.astype(dtypes.unsigned_container(d)).view(d)


class Range(Dataset):
    """iota starting at the type minimum (src/Dataset.h Range) — already
    sorted input."""

    name = "Range"

    def _fill(self, n):
        d = self.dtype
        if d.kind == "f":
            return np.arange(n, dtype=d)
        start = np.iinfo(d).min
        u = dtypes.unsigned_container(d)
        # wraparound-safe iota from the minimum.
        base = np.arange(n, dtype=u)
        return (base + np.uint64(start & ((1 << (d.itemsize * 8)) - 1)).astype(u)).view(d) \
            if d.kind == "i" else (base + u.type(start)).astype(d)


class InvertedRange(Dataset):
    """Reversed iota (src/Dataset.h InvertedRange) — worst case for
    adaptive sorts."""

    name = "InvertedRange"

    def _fill(self, n):
        return Range(self.dtype)._fill(n)[::-1].copy()


ALL_DATASETS = (Zeros, RandomDistributed, Random, Range, InvertedRange)


def make_datasets(dtype, seed: int | None = 0):
    """The reference's DatasetCreator fan-out (tests/tests.cpp:17-27): one of
    each distribution.  ``seed`` pins RandomDistributed for reproducible CI
    (pass None for the reference's time-seeded behavior)."""
    out = []
    for cls in ALL_DATASETS:
        if cls is RandomDistributed:
            out.append(cls(dtype, seed=seed))
        else:
            out.append(cls(dtype))
    return out
