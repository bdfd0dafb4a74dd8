"""Fluent query layer over Table — the user-facing face of the engine.

Port of ``radix_sort_tpu/query.py``.  ``Query`` chains lazily and runs the
chain on ``.collect()`` through the engine's operators:

    q = (Query(table)
         .filter("k", "lt", 500)
         .group_by("k", n=("count", None), s=("sum", "x"))
         .join(other, on="k")
         .sort_by("k"))
    result = q.collect()          # Table

Every operator is the port's: compaction by the radix kernels' stable
pass, sort-based aggregate, sort-merge join, window functions; sorts go
through the query's ``SortConfig``.  ``collect()`` never reads
``num_rows`` to the host: ``limit`` clamps it on the device
(``Table.head``).
"""

from __future__ import annotations

from . import dtypes
from .config import DEFAULT_CONFIG, SortConfig
from .ops import aggregate as agg_ops
from .ops import filter as filt_ops
from .ops import join as join_ops
from .ops import sort as sort_ops
from .ops import topk as topk_ops
from .ops import window as win_ops
from .table import Table


def _sort_table(table: Table, key: str, descending: bool = False,
                config: SortConfig = DEFAULT_CONFIG) -> Table:
    """One stable sort of every column of ``table`` by ``key``, padding
    rows last: the key's sortable image, inverted within the key's width
    when ``descending``, with the padding sentinel on rows past
    ``num_rows``."""
    col = table[key]
    width = dtypes.key_bits(col.dtype)
    bits = dtypes.to_sortable(col)
    if descending:
        bits = dtypes.complement(bits, width)
    bits = bits.masked_fill(~table.valid_mask(), dtypes.SENTINEL_BITS)
    names = table.column_names
    _, out = sort_ops.sort_biased_kv(
        bits, tuple(table.columns[n] for n in names), config, width)
    return Table(dict(zip(names, out)), num_rows=table.num_rows)


class Query:
    def __init__(self, table: Table, config: SortConfig = DEFAULT_CONFIG):
        self._table = table
        self._config = config
        self._steps = []
        self._stats = {}

    # ---- operators (lazy) -------------------------------------------------
    def filter(self, column: str, op: str, value) -> "Query":
        self._steps.append(("filter", (column, op, value)))
        return self

    def filter_mask(self, fn) -> "Query":
        """fn: Table -> bool mask tensor."""
        self._steps.append(("filter_mask", (fn,)))
        return self

    def select(self, *columns) -> "Query":
        if len(columns) == 1 and not isinstance(columns[0], str):
            columns = tuple(columns[0])
        self._steps.append(("select", (columns,)))
        return self

    def with_column(self, name: str, fn) -> "Query":
        """fn: Table -> new column tensor."""
        self._steps.append(("with_column", (name, fn)))
        return self

    def group_by(self, key: str, **aggs) -> "Query":
        """aggs: out_name=(op, input_column)."""
        self._steps.append(("group_by", (key, dict(aggs))))
        return self

    def join(self, other: Table, on: str, max_duplicates: int = 1,
             suffixes=("", "_r")) -> "Query":
        self._steps.append(("join", (other, on, max_duplicates, suffixes)))
        return self

    def distinct(self, column: str) -> "Query":
        """One row per distinct value of ``column`` (first occurrence),
        ascending order."""
        self._steps.append(("distinct", (column,)))
        return self

    def top_k(self, column: str, k: int, largest: bool = True) -> "Query":
        """ORDER BY column (DESC if largest) LIMIT k."""
        self._steps.append(("top_k", (column, k, largest)))
        return self

    def limit(self, n: int) -> "Query":
        """Keep the first n rows of the current result."""
        self._steps.append(("limit", (n,)))
        return self

    def window(self, partition: str, order: str, **specs) -> "Query":
        """Append window-function columns over (PARTITION BY ``partition``,
        ORDER BY ``order``): ``out_name=("row_number",)``, ``("rank",)``,
        ``("dense_rank",)``, ``("cum_sum", col)``, ``("cum_min"|"cum_max"|
        "first_value", col)``, ``("lag"|"lead", col[, k[, fill]])``."""
        self._steps.append(("window", (partition, order, dict(specs))))
        return self

    def sort_by(self, *keys: str, descending=False) -> "Query":
        """Sort by one or more key columns (first = most significant).
        ``descending`` is a bool for all keys or a per-key sequence.
        Multi-key order is LSD-style: successive stable sorts from the
        least-significant key, the composition the radix sort itself uses
        for its digits."""
        if len(keys) == 1 and not isinstance(keys[0], str):
            keys = tuple(keys[0])
        if isinstance(descending, bool):
            desc = (descending,) * len(keys)
        else:
            desc = tuple(descending)
            if len(desc) != len(keys):
                raise ValueError(
                    f"descending has {len(desc)} entries for {len(keys)} keys")
        for k, d in reversed(tuple(zip(keys, desc))):
            self._steps.append(("sort_by", (k, d)))
        return self

    # ---- execution --------------------------------------------------------
    def collect(self) -> Table:
        cfg = self._config
        t = self._table
        for step, args in self._steps:
            if step == "filter":
                col, op, value = args
                t = filt_ops.filter_expr(t, col, op, value, config=cfg)
            elif step == "filter_mask":
                (fn,) = args
                t = filt_ops.filter_table(t, fn(t), config=cfg)
            elif step == "select":
                (cols,) = args
                t = t.select(cols)
            elif step == "with_column":
                name, fn = args
                t = t.with_columns(**{name: fn(t)})
            elif step == "group_by":
                key, aggs = args
                t = agg_ops.hash_aggregate(t, key, aggs, config=cfg)
            elif step == "distinct":
                (col,) = args
                t = agg_ops.distinct(t, col, config=cfg)
            elif step == "top_k":
                col, k, largest = args
                t = topk_ops.topk_table(t, col, k, largest=largest,
                                        config=cfg)
            elif step == "limit":
                (n,) = args
                t = t.head(n)
            elif step == "join":
                other, on, max_dup, suffixes = args
                t, stats = join_ops.hash_join(
                    t, other, on, max_duplicates=max_dup,
                    suffixes=suffixes, config=cfg)
                self._stats["join"] = stats
            elif step == "window":
                partition, order, specs = args
                t = win_ops.table_window(t, partition, order, specs,
                                         config=cfg)
            elif step == "sort_by":
                key, desc = args
                t = _sort_table(t, key, desc, config=cfg)
            else:  # pragma: no cover
                raise ValueError(step)
        return t

    @property
    def last_stats(self):
        return dict(self._stats)
