"""Stable-rank machinery in plain torch: the plain radix pass.

Port of ``radix_sort_tpu/ops/ranking.py``, the counterpart of the JAX
package's ``xla_radix`` pipeline.  For every element the stable
destination of one pass is

    dest = global_base[digit] + block_prefix[block, digit] + in_block_rank

where the digit-major (digit, then block, then position) exclusive scan is
the layout that makes the scatter stable (``RadixSort.cl:69``).

These functions are the plain versions the kernels of ``cuda_radix`` are
held against, and what a CPU tensor runs.  They work on any device.
"""

from __future__ import annotations

import torch

from .. import dtypes


def block_digit_counts(digits: torch.Tensor, radix: int) -> torch.Tensor:
    """Per-block digit histogram: (B, M) digits in [0, radix) → (B, R)
    int32 counts."""
    B = digits.shape[0]
    blk = torch.arange(B, device=digits.device, dtype=torch.int64)[:, None]
    flat = (blk * radix + digits.to(torch.int64)).reshape(-1)
    return torch.bincount(flat, minlength=B * radix).view(B, radix).to(
        torch.int32)


def tile_ranks(digits: torch.Tensor, radix: int, tile: int):
    """Stable rank of every element among the equal digits of its tile.

    digits: (n,) in [0, radix); tiles are consecutive runs of ``tile``
    elements, the last one ragged.  Returns (counts (B, R) int64, rank (n,)
    int64)."""
    n = digits.shape[0]
    B = -(-n // tile)
    pos = torch.arange(n, device=digits.device, dtype=torch.int64)
    key = (pos // tile) * radix + digits.to(torch.int64)
    counts = torch.bincount(key, minlength=B * radix)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(key, stable=True).indices
    slot = torch.empty_like(order)
    slot[order] = pos
    return counts.view(B, radix), slot - starts[key]


def stable_dest(digits: torch.Tensor, radix: int):
    """Global stable destinations for a bucketed reorder.

    Args:
      digits: (B, M) bucket ids in [0, radix).
      radix: number of buckets R.

    Returns:
      dest:   (B, M) int64 — flat destination index in [0, B*M).
      counts: (B, R) int32 — per-block digit histogram.
      total:  (R,)  int32 — global digit histogram.
    """
    B, M = digits.shape
    counts, rank = tile_ranks(digits.reshape(-1), radix, M)
    total = counts.sum(0)
    global_base = torch.cumsum(total, 0) - total
    block_prefix = torch.cumsum(counts, 0) - counts
    base = global_base[None, :] + block_prefix
    dest = torch.gather(base, 1, digits.to(torch.int64)) + rank.view(B, M)
    return dest, counts.to(torch.int32), total.to(torch.int32)


def apply_destinations(dest: torch.Tensor, arrays):
    """Scatter each array to its destinations: out[dest[i]] = a[i]."""
    outs = []
    for a in arrays:
        c = dtypes.as_container(a)
        out = torch.empty_like(c)
        out[dest] = c
        outs.append(dtypes.from_container(out, a.dtype))
    return tuple(outs)
