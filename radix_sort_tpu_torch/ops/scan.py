"""Prefix-scan utilities — public wrappers over the scan machinery.

Port of ``radix_sort_tpu/ops/scan.py``.
"""

from __future__ import annotations

import torch

from . import cuda_radix


def exclusive_scan(x: torch.Tensor, engine: str = "torch") -> torch.Tensor:
    """Exclusive prefix sum of a 1-D tensor, in its own dtype.

    engine="torch": ``torch.cumsum``.
    engine="kernel": the exclusive-scan kernel (int32 only; its plain
    version on a CPU tensor).
    """
    if engine == "kernel":
        return cuda_radix.exclusive_scan(x)
    if engine != "torch":
        raise ValueError(f"unknown scan engine {engine!r}")
    return torch.cumsum(x, 0, dtype=x.dtype) - x


def inclusive_scan(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0, dtype=x.dtype)


def segment_boundaries(sorted_keys: torch.Tensor):
    """Run-boundary mask and int32 segment ids for a sorted key column: the
    building block of the sorted GROUP BY (ops/aggregate.py)."""
    n = sorted_keys.shape[0]
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=sorted_keys.device)
        return z.to(torch.bool), z
    is_new = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_new[1:] = sorted_keys[1:] != sorted_keys[:-1]
    return is_new, torch.cumsum(is_new, 0, dtype=torch.int32) - 1


def last_marked_index(mark: torch.Tensor) -> torch.Tensor:
    """For every row, the index of the last row at or before it whose
    ``mark`` is set (``mark[0]`` must be set): number the marked rows with a
    cumulative sum, scatter each marked row's index to its number, gather
    back.  (A running max of the marked positions, ``torch.cummax``, gives
    the same and was the slowest step of the join on the card.)"""
    n = mark.shape[0]
    pos = torch.arange(n, device=mark.device)
    k = torch.cumsum(mark, 0) - 1
    # unmarked rows all write the spare slot n, which is never read
    first = torch.empty(n + 1, dtype=pos.dtype, device=mark.device)
    first.scatter_(0, torch.where(mark, k, n), pos)
    return first[k]


def segmented_exclusive_scan(x: torch.Tensor,
                             seg_ids: torch.Tensor) -> torch.Tensor:
    """Exclusive scan that restarts at each segment boundary (seg_ids must
    be non-decreasing): the global exclusive scan minus its value at the
    segment's first row."""
    n = x.shape[0]
    if n == 0:
        return x
    total = torch.cumsum(x, 0, dtype=x.dtype) - x
    first = torch.ones(n, dtype=torch.bool, device=x.device)
    first[1:] = seg_ids[1:] != seg_ids[:-1]
    return total - total[last_marked_index(first)]
