"""Key distributions of the sort suite, made on the device.

A frozen copy of the rules of gyatskov/radix-sort's ``Performance/``
datasets as the port's ``datasets_device.py`` makes them on the card:
``Zeros``; ``Range`` / ``InvertedRange`` (the dtype's minimum counting
up, or its reverse); ``Random``, uniform random bits (floats uniform in
[-1e9, 1e9), half floats over their finite range); ``RandomDistributed``,
the same with the dtype's extremes planted at rows 0 and n - 1 (-inf and
+inf for floats).  Unsigned 16/32/64-bit keys come as views of their
signed containers' bits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import seeds

NAMES = ("Zeros", "Range", "InvertedRange", "Random", "RandomDistributed")

_TORCH = {
    "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "uint16": torch.uint16, "int32": torch.int32, "uint32": torch.uint32,
    "int64": torch.int64, "uint64": torch.uint64, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def torch_dtype(name: str) -> torch.dtype:
    return _TORCH[name]


def _bits(n: int, width: int, gen, device) -> torch.Tensor:
    """``n`` uniform ``width``-bit patterns in the signed container of the
    width."""
    def draw(low, high):
        return torch.randint(low, high, (n,), generator=gen,
                             dtype=torch.int64, device=device)

    if width == 64:
        return draw(-2**31, 2**31) * 2**32 | draw(0, 2**32)
    u = draw(0, 1 << width)
    u = torch.where(u >= 1 << (width - 1), u - (1 << width), u)
    return u.to(_SIGNED[width // 8])


def _view(signed: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == signed.dtype:
        return signed
    if dtype == torch.uint8:
        return signed.view(torch.uint8)
    return signed.view(dtype)


def generate(name: str, dtype_name: str, n: int, seed: int, device,
             stream_path=("keys",)) -> torch.Tensor:
    """``n`` keys of distribution ``name`` and dtype ``dtype_name`` on
    ``device``, the same for the same seed."""
    if name not in NAMES:
        raise ValueError(f"unknown key distribution {name!r}")
    d = np.dtype(dtype_name)
    td = _TORCH[dtype_name]
    width = 8 * d.itemsize
    if name == "Zeros":
        return torch.zeros(n, dtype=td, device=device)
    if name in ("Range", "InvertedRange"):
        base = torch.arange(n, dtype=torch.int64, device=device)
        if name == "InvertedRange":
            base = base.flip(0)
        if d.kind == "f":
            return base.to(td)
        base = base + (int(np.iinfo(d).min) if d.kind == "i" else 0)
        # the low bits of the count, as the dtype's own wraparound
        return _view(_wrap(base, width), td)
    gen = seeds.generator(device, seed, *stream_path)
    if d.kind == "f":
        lim = min(1e9, float(np.finfo(d).max))
        wide = torch.float32 if d.itemsize < 4 else td
        out = torch.rand(n, generator=gen, dtype=wide, device=device)
        out = (out * (2 * lim) - lim).to(td)
        if name == "RandomDistributed" and n >= 2:
            out[0], out[n - 1] = float("-inf"), float("inf")
        return out
    signed = _bits(n, width, gen, device)
    if name == "RandomDistributed" and n >= 2:
        if d.kind == "u":  # 0 and all bits set
            signed[0], signed[n - 1] = 0, -1
        else:
            signed[0] = int(np.iinfo(d).min)
            signed[n - 1] = int(np.iinfo(d).max)
    return _view(signed, td)


def _wrap(x: torch.Tensor, width: int) -> torch.Tensor:
    """int64 values → the ``width``-bit signed container holding their low
    bits."""
    if width == 64:
        return x
    low = x & ((1 << width) - 1)
    low = torch.where(low >= 1 << (width - 1), low - (1 << width), low)
    return low.to(_SIGNED[width // 8])
