"""Independent streams from one run seed.

``stream(seed, *path)`` is a 64-bit seed for one generator, fixed by the
run seed and a path such as ("lineitem", "l_quantity"): numpy's
``SeedSequence``, whose output is stable across numpy
versions.  Seeds of any size are taken (the driver's exceed 32 bits)."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def _word(part) -> int:
    if isinstance(part, int):
        return part
    return zlib.crc32(str(part).encode())


def stream(seed: int, *path) -> int:
    words = [int(seed) % (1 << 64)] + [_word(p) for p in path]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0])


def generator(device, seed: int, *path) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream(seed, *path))
    return g
