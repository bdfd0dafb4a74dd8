"""Stable partition / radix partition — the reusable reorder primitive.

Port of ``radix_sort_tpu/ops/partition.py``.  Filter, aggregate and join
compactions are all "partition by a bucket id"; ``method="auto"`` sends
them to one stable pass of the radix kernels (ops/stream.py).  The JAX
package's v5e size thresholds (``_auto_method``) have no counterpart: on
the card the kernel pass is the engine for every size.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from . import ranking, stream

METHODS = ("auto", "stream", "sort", "rank")


def _bucket_counts(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Rows per bucket; ids outside [0, num_buckets) are not counted."""
    inside = (ids >= 0) & (ids < num_buckets)
    idx = torch.where(inside, ids, num_buckets)
    return stream.bucket_counts(idx, num_buckets + 1)[:num_buckets]


def stable_partition(bucket_ids: torch.Tensor, arrays, num_buckets: int,
                     method: str = "sort",
                     config: SortConfig = DEFAULT_CONFIG):
    """Stably reorder ``arrays`` so rows with equal ``bucket_ids`` become
    contiguous, buckets in ascending id order.

    Returns (reordered_arrays, bucket_counts, bucket_starts), the counts
    and starts as (num_buckets,) int32.

    method="stream" (and "auto"): the radix kernels' stable pass
    (stream.partition_planes).  Ids must lie in [0, num_buckets): an id
    outside wraps into a low bucket.
    method="sort": ``torch.sort(stable=True)`` keyed on the id; ids outside
    the range are ordered by value (after the last bucket when larger),
    the layout exchange-style callers rely on.
    method="rank": the plain rank-and-scatter pipeline of ops/ranking.py,
    for in-range ids; tests use it to cross-check.
    """
    if method not in METHODS:
        raise ValueError(f"unknown partition method {method!r}")
    ids = bucket_ids.to(torch.int32)
    n = ids.shape[0]
    arrays = tuple(arrays)
    if method in ("auto", "stream"):
        planes, specs = stream.payloads_to_planes(arrays)
        outs, total = stream.partition_planes(
            ids, planes, num_buckets, tile=config.tile_elems,
            threads=config.threads_per_cta)
        out = stream.planes_to_payloads(outs, specs)
    elif method == "sort":
        order = torch.sort(ids, stable=True).indices
        out = tuple(dtypes.from_container(dtypes.as_container(a)[order],
                                          a.dtype) for a in arrays)
        total = _bucket_counts(ids, num_buckets)
    else:
        m = min(config.tile_elems, stream._next_pow2(max(n, 1)))
        padded = -(-max(n, 1) // m) * m
        ids_p = torch.cat([ids, ids.new_full((padded - n,), num_buckets)])
        dest, _, total = ranking.stable_dest(ids_p.view(-1, m),
                                             num_buckets + 1)
        dest = dest.view(-1)[:n]  # padding ranks last: dest < n for real rows
        out = ranking.apply_destinations(dest, arrays)
        total = total[:num_buckets]
    starts = torch.cumsum(total, 0, dtype=torch.int32) - total
    return out, total, starts


def compact_mask(mask: torch.Tensor, arrays, method: str = "sort",
                 config: SortConfig = DEFAULT_CONFIG):
    """Stable compaction: rows with mask=True move to the front, in order;
    returns (compacted_arrays, kept_count) with kept_count a 0-d int32
    tensor.  This is stable_partition with buckets (kept=0, dropped=1)."""
    bucket = torch.where(mask, 0, 1).to(torch.int32)
    out, counts, _ = stable_partition(bucket, arrays, 2, method=method,
                                      config=config)
    return out, counts[0]


def compact_prefix_slots(arrays, counts: torch.Tensor, slot_len: int):
    """Compact S fixed-length slots whose valid rows are each slot's prefix
    into one contiguous prefix (order preserved across and within slots).

    ``arrays`` are (S * slot_len,); slot s's valid rows are its first
    ``counts[s]``.  Returns (arrays, total) with every valid row packed at
    the front; rows past ``total`` are zero."""
    counts = counts.to(torch.int64)
    S = counts.shape[0]
    offs = torch.cumsum(counts, 0) - counts
    j = torch.arange(slot_len, device=counts.device)
    valid = (j[None, :] < counts[:, None]).reshape(-1)
    dst = (offs[:, None] + j[None, :]).reshape(-1)[valid]
    outs = []
    for a in arrays:
        c = dtypes.as_container(a)
        buf = torch.zeros_like(c)
        buf[dst] = c.view(S * slot_len)[valid]
        outs.append(dtypes.from_container(buf, a.dtype))
    return tuple(outs), counts.sum().to(torch.int32)


def radix_partition(keys_bits: torch.Tensor, arrays, bits: int,
                    shift: int = 0, method: str = "sort",
                    config: SortConfig = DEFAULT_CONFIG):
    """Partition rows by the key digit ``(keys_bits >> shift) & (2^bits-1)``
    of sortable key bits: the building block of a partitioned hash join
    and of a cross-device shuffle."""
    radix = 1 << bits
    digits = (keys_bits >> shift) & (radix - 1)
    return stable_partition(digits.to(torch.int32), arrays, radix,
                            method=method, config=config)
