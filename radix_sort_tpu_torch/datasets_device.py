"""Device-side dataset generation.

Port of ``radix_sort_tpu/datasets_device.py``: the host generators of
datasets.py made on the device with a ``torch.Generator`` there, so
benchmark data never crosses from the host.  The contract is the JAX
package's, not its random bits: the dtype and shape, all-zero ``Zeros``,
``Range`` / ``InvertedRange`` equal to the host datasets, uniform random
bits (floats uniform in [-1e9, 1e9), float16 in its finite range) with the
dtype's extremes planted at index 0 and n-1 for ``RandomDistributed``
(-inf and +inf for floats).  Where the JAX twin's shape or range fails
(an (n, 8 / itemsize) array for 1- and 2-byte signed ints, NaN between
the plants for float16), the port keeps the contract.

``Random`` (fixed-seed mt19937 on the host) has no device twin: it draws
the same uniform bits as ``RandomDistributed`` without the planted
extremes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import dtypes

ALL_NAMES = ("Zeros", "RandomDistributed", "Random", "Range",
             "InvertedRange")


def _random_bits(n: int, width: int, gen: torch.Generator, device):
    """``n`` uniform ``width``-bit patterns in the signed container (int32
    up to 32 bits, int64 for 64).  ``torch.randint`` draws below a
    ``high`` of at most 2^63 - 1, so a 64-bit word is two 32-bit draws."""
    def draw(low, high):
        return torch.randint(low, high, (n,), generator=gen,
                             dtype=torch.int64, device=device)

    if width == 64:  # high word signed, so the product cannot overflow
        return draw(-2**31, 2**31) * 2**32 | draw(0, 2**32)
    return draw(0, 1 << width).to(torch.int32)


def generate(name: str, dtype, n: int, seed: int = 0, device="cuda"):
    """Dataset ``name`` of ``n`` keys of ``dtype`` as a tensor on
    ``device`` (the card unless the caller asks for the CPU).  Names are
    ``ALL_NAMES``; ints and floats of every width the sort takes."""
    if name not in ALL_NAMES:
        raise ValueError(f"unknown dataset {name!r}")
    d = np.dtype(dtype)
    td = dtypes.torch_dtype(d)
    width = 8 * d.itemsize
    if name == "Zeros":
        return torch.zeros(n, dtype=td, device=device)
    if name in ("Range", "InvertedRange"):
        base = torch.arange(n, dtype=torch.int64, device=device)
        if name == "InvertedRange":
            base = base.flip(0)
        if d.kind == "f":
            return base.to(td)
        # signed keys count up from the dtype's minimum, as on the host
        return _narrow(base + (np.iinfo(d).min if d.kind == "i" else 0), d)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if d.kind == "f":
        # float16 draws in float32 over its own finite range
        lim = min(1e9, float(np.finfo(d).max))
        wide = torch.float32 if d.itemsize < 4 else td
        out = torch.rand(n, generator=gen, dtype=wide, device=device)
        out = (out * (2 * lim) - lim).to(td)
    else:
        out = _narrow(_random_bits(n, width, gen, device), d)
    if name == "RandomDistributed" and n >= 2:
        c = dtypes.as_container(out)
        if d.kind == "f":
            lo, hi = float("-inf"), float("inf")
        elif c.dtype != out.dtype:  # uint16/32/64 in signed containers
            lo, hi = 0, -1  # all bits set in the signed container
        else:
            lo, hi = int(np.iinfo(d).min), int(np.iinfo(d).max)
        c[0], c[n - 1] = lo, hi
    return out


def _narrow(x: torch.Tensor, d: np.dtype) -> torch.Tensor:
    """int32/int64 values → ``d``, keeping the low bits (uint32/uint64 as
    views of their signed containers)."""
    if d.itemsize == 8:
        return dtypes.from_container(x.to(torch.int64), d)
    if d.itemsize == 4:
        return dtypes.from_container(x.to(torch.int32), d)
    return x.to(torch.int32).to(dtypes.torch_dtype(d))
