"""Ordered selection: top-k (ORDER BY ... LIMIT k) over keys and tables.

Port of ``radix_sort_tpu/ops/topk.py``, with its contract: the output is
best-first (descending key for ``largest``, ascending otherwise) and stable
on ties (an earlier row wins).  Keys go through ``dtypes.to_sortable``, so
every key type shares one ordering.  Two paths, as in the JAX package:

  - small k (<= n/4) with keys of at most 4 bytes: ``torch.topk`` on a
    composite int64 key, the score in the high word and the complement of
    the row index in the low word.  Composite keys are unique, so the
    selection is stable whatever ``torch.topk`` does with ties (it does not
    resolve them by index, unlike ``lax.top_k``);
  - large k, and 8-byte keys of any k: the engine's stable sort of the
    complement of the score (``sort_biased_kv`` with the caller's config)
    and a slice.  A key-only large-k selection under ``engine="merge"``
    runs the merge-sort kernels.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from ..table import Table
from . import sort as sort_ops


def _complement(bits: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Reverse the unsigned order of ``total_bits``-wide sortable bits,
    keeping a 16-bit image inside its 16 bits."""
    if total_bits == 8 * bits.element_size():
        return ~bits
    return bits ^ ((1 << total_bits) - 1)


def _scores(bits: torch.Tensor, largest: bool, total_bits: int):
    """Sortable image where 'better' is larger in unsigned order."""
    return bits if largest else _complement(bits, total_bits)


def _check_k(k: int, n: int):
    if not isinstance(k, (int, np.integer)) or k < 0:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"k must be a non-negative int, got {k!r}")
    if k > n:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"k={k} exceeds capacity {n}")


def _gather(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return dtypes.from_container(dtypes.as_container(p)[idx], p.dtype)


def _top_k_impl(bits: torch.Tensor, payloads, k: int, largest: bool,
                config: SortConfig, total_bits: int):
    """Sortable key bits (``total_bits`` wide) + payload tuple →
    (bits[k], payloads[k]), best-first, ties in row order."""
    n = bits.shape[0]
    _check_k(k, n)
    if k == 0:
        return bits[:0], tuple(p[:0] for p in payloads)
    score = _scores(bits, largest, total_bits)
    if k <= max(1, n // 4) and bits.element_size() == 4:
        high = dtypes.signed_order(score).to(torch.int64) << 32
        low = torch.arange(n - 1, -1, -1, dtype=torch.int64,
                           device=bits.device)
        idx = torch.topk(high | low, k, sorted=True).indices
        return bits[idx], tuple(_gather(p, idx) for p in payloads)
    # Sorting the COMPLEMENT of the score ascends best-first with ties in
    # row order (reversing an ascending stable sort would reverse them).
    inv_sorted, pls = sort_ops.sort_biased_kv(
        _complement(score, total_bits), tuple(payloads), config, total_bits)
    # the sorted complement of the score, which for ``largest=False`` is
    # the key bits themselves
    out = inv_sorted[:k]
    return (_complement(out, total_bits) if largest else out,
            tuple(p[:k] for p in pls))


def top_k(keys: torch.Tensor, k: int, *, largest: bool = True,
          config: SortConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """The k largest (or smallest) keys, best-first, stable on ties."""
    out, _ = _top_k_impl(dtypes.to_sortable(keys), (), k, largest, config,
                         dtypes.key_bits(keys.dtype))
    return dtypes.from_sortable(out, keys.dtype)


def top_k_kv(keys: torch.Tensor, values, k: int, *, largest: bool = True,
             config: SortConfig = DEFAULT_CONFIG):
    """Top-k with a payload pytree; every leaf rides the same selection."""
    leaves, spec = pytree.tree_flatten(values)
    for leaf in leaves:
        if leaf.shape[0] != keys.shape[0]:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"value leaf length {leaf.shape[0]} != keys {keys.shape[0]}")
    out, out_leaves = _top_k_impl(dtypes.to_sortable(keys), tuple(leaves), k,
                                  largest, config, dtypes.key_bits(keys.dtype))
    return (dtypes.from_sortable(out, keys.dtype),
            pytree.tree_unflatten(list(out_leaves), spec))


def topk_table(table: Table, key: str, k: int, *, largest: bool = True,
               config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Table-level ORDER BY key (DESC if largest) LIMIT k.

    Padding rows always lose: their score is forced to the minimum, and
    because valid rows form a prefix the stable tie break keeps real
    minimum-scored rows ahead of padding.  Output capacity is k;
    ``num_rows`` = min(k, input rows)."""
    _check_k(k, table.capacity)
    total_bits = dtypes.key_bits(table[key].dtype)
    score = _scores(dtypes.to_sortable(table[key]), largest, total_bits)
    score = torch.where(table.valid_mask(), score, torch.zeros_like(score))
    names = table.column_names
    # the selection runs on the score image; every column, the key in its
    # own dtype included, rides as payload
    _, out = _top_k_impl(score, tuple(table.columns[nm] for nm in names), k,
                         True, config, total_bits)
    return Table(dict(zip(names, out)),
                 num_rows=torch.clamp(table.num_rows, max=k))
