"""Filter: predicate → stable compaction (BASELINE config 3).

Port of ``radix_sort_tpu/ops/filter.py``: a filter is a stable partition
into (kept, dropped) whose dropped tail becomes padding.  Capacity stays;
``num_rows`` carries the kept count.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..table import Table
from . import partition

_COMPARE = {
    "eq": torch.eq, "ne": torch.ne,
    "lt": torch.lt, "le": torch.le,
    "gt": torch.gt, "ge": torch.ge,
}


def filter_table(table: Table, mask: torch.Tensor,
                 config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Keep rows where ``mask`` is True (padding rows are always dropped),
    preserving order.  The compaction is the radix kernels' stable pass
    (method="auto")."""
    mask = mask & table.valid_mask()
    names = table.column_names
    out, kept = partition.compact_mask(
        mask, tuple(table.columns[n] for n in names), method="auto",
        config=config)
    return Table(dict(zip(names, out)), num_rows=kept)


def filter_expr(table: Table, column: str, op: str, value,
                config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Comparison filter ``column <op> value``, op in {eq,ne,lt,le,gt,ge},
    compared in the column's own type (unsigned columns in unsigned
    order)."""
    if op not in _COMPARE:
        raise ValueError(f"unknown comparison {op!r}")
    col = table[column]
    if dtypes.container_dtype(col.dtype) != col.dtype:
        # uint16/32/64 have no ordered comparisons in torch: compare the
        # sign-flipped signed containers, whose signed order is the same.
        bits = dtypes.key_bits(col.dtype)
        v = int(value) & ((1 << bits) - 1)
        v = v - (1 << bits) if v >> (bits - 1) else v
        lhs = dtypes.signed_order(dtypes.as_container(col))
        rhs = v ^ dtypes.sign_bit(bits)
        return filter_table(table, _COMPARE[op](lhs, rhs), config)
    return filter_table(table, _COMPARE[op](col, value), config)
