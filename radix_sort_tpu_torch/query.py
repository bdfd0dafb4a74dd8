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
through the query's ``SortConfig``.

Intermediate tables are cut to their valid rows.  A step that changes
the row count (filter, join, group-by, distinct, top-k) leaves its
input's capacity, mostly padding after a selective filter or join.
Before the next step whose work follows the capacity (join, group-by,
distinct, window, sort, top-k), ``collect()`` reads ``num_rows`` to the
host once (a join reads its build side's count in the same read) and
slices every column to ``max(n, 1)`` rows, or to the rows a later
top-k's ``k`` asks of them through the steps between: views, no copy.  The JAX package never reads a
count, as XLA needs static shapes; CUDA has dynamic shapes, and one read
costs a drain of the stream, tens of microseconds against steps that
take milliseconds over the padding.  A count once read is carried by the
steps that keep it (select, with_column, sort, window, limit), which
read nothing again.  The table the ``Query`` was given is never read
nor cut, so a chain whose count never changed runs as the JAX one does.
``filter_mask`` and ``with_column`` functions see the cut table.

The result keeps the capacity of the uncut chain, the JAX package's
(the steps' own rules: a join gives probe capacity x ``max_duplicates``,
``limit(n)`` ``min(n, capacity)``, ``top_k`` k, any other step its
input's): after a cut the valid rows lead columns of that capacity
whose rows past ``num_rows`` are unwritten padding.  ``host_reads`` and
``rows_cut`` count the reads and the padding rows cut away, over every
``Query`` of the process; the span ``query.cut`` (attributes ``rows``
before, ``kept`` after) lies inside its step's span.
"""

from __future__ import annotations

import numbers

import torch

from . import dtypes
from .config import DEFAULT_CONFIG, SortConfig
from .ops import aggregate as agg_ops
from .ops import filter as filt_ops
from .ops import join as join_ops
from .ops import sort as sort_ops
from .ops import topk as topk_ops
from .ops import window as win_ops
from .table import Table
from .utils import profiling

# the span of each step kind, named once (a span that is off allocates
# nothing)
_STEP_SPANS = {step: "query." + step for step in (
    "filter", "filter_mask", "select", "with_column", "group_by", "join",
    "distinct", "top_k", "limit", "window", "sort_by")}

# steps whose row count is known only on the device, and steps whose work
# follows the capacity, before which the table is cut
_COUNT_CHANGING = frozenset(("filter", "filter_mask", "join", "group_by",
                             "distinct", "top_k"))
_CUT_BEFORE = frozenset(("join", "group_by", "distinct", "window",
                         "sort_by", "top_k"))

# Reads of row counts to the host and padding rows cut away, over every
# Query of the process; read as join.sorted_rows is.
host_reads = 0
rows_cut = 0


def _sort_table(table: Table, key: str, descending: bool = False,
                config: SortConfig = DEFAULT_CONFIG) -> Table:
    """One stable sort of every column of ``table`` by ``key``, padding
    rows last (``sort.padded_key``), at the key's width."""
    names = table.column_names
    _, out = sort_ops.sort_biased_kv(
        sort_ops.padded_key(table[key], table.valid_mask(), descending),
        tuple(table.columns[n] for n in names), config,
        dtypes.key_bits(table[key].dtype))
    return Table(dict(zip(names, out)), num_rows=table.num_rows)


def _widen(table: Table, capacity: int, valid: int | None) -> Table:
    """``table``'s rows leading columns of ``capacity`` rows: the first
    ``valid`` rows copied (all of them when the count is not on the host),
    the rest unwritten."""
    rows = table.capacity if valid is None else valid
    cols = {}
    for k, v in table.columns.items():
        c = dtypes.as_container(v)
        out = c.new_empty(capacity)
        out[:rows] = c[:rows]
        cols[k] = dtypes.from_container(out, v.dtype)
    return Table(cols, table.num_rows)


def _capacity_after(step: str, args, capacity: int) -> int:
    """The capacity the uncut chain's step gives an input of
    ``capacity`` rows."""
    if step == "join":
        return capacity * args[2]
    if step == "top_k":
        return args[1]
    if step == "limit":
        return min(args[0], capacity)
    return capacity


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
        """Run the chain: one span ``query``, and inside it one span
        ``query.<step>`` a step (``profiling.span``), which holds the
        step's ``query.cut`` where the table is cut before it."""
        cfg = self._config
        t = self._table
        capacity = t.capacity  # the uncut chain's
        n = None  # t's num_rows on the host, once read
        stale = False  # a step since the last read changed the count
        with profiling.span("query", rows=t.capacity,
                            steps=len(self._steps)):
            for i, (step, args) in enumerate(self._steps):
                with profiling.span(_STEP_SPANS[step], rows=t.capacity):
                    if step in _CUT_BEFORE and (stale or n is not None):
                        t, n, args = self._cut(t, n, step, args,
                                               self._cut_floor(i))
                        stale = False
                    t = self._run_step(t, step, args, cfg)
                capacity = _capacity_after(step, args, capacity)
                if step in ("top_k", "limit") and n is not None:
                    n = min(n, args[1] if step == "top_k" else args[0])
                elif step in _COUNT_CHANGING:
                    n, stale = None, True
            if t.capacity < capacity:
                t = _widen(t, capacity, n)
        return t

    def _cut_floor(self, i: int) -> int:
        """The fewest rows a cut before step ``i`` may keep: 1, or the
        capacity a later top_k's k asks of its input, carried back to step
        ``i`` through the steps' capacity rules (a join multiplies its
        probe's by ``max_duplicates``, a top_k sets k, every other step
        keeps its input's).  A later cut cannot grow the table, so the
        floor holds up to the top_k."""
        need = 1
        for step, args in reversed(self._steps[i:]):
            if step == "top_k":
                k = args[1]
                need = max(1, int(k)) if isinstance(k, numbers.Integral) else 1
            elif step == "join":
                need = -(-need // max(1, args[2]))
        return need

    @staticmethod
    def _cut(t: Table, n: int | None, step: str, args, floor: int):
        """``t``, and a join's build table, cut to their valid rows (at
        least ``floor`` and 1) before ``step``, with one host read of the
        counts not yet on the host.  Returns the table, its count and the
        step's arguments."""
        global host_reads, rows_cut
        other = args[0] if step == "join" else None
        if other is None and t.capacity <= max(floor, n or 0):
            return t, n, args  # nothing to cut: no read
        before = t.capacity + (0 if other is None else other.capacity)
        with profiling.span("query.cut", rows=before) as sp:
            unread = [t.num_rows] if n is None else []
            if other is not None:
                unread.append(other.num_rows)
            if unread:
                host_reads += 1
                counts = torch.stack(unread).tolist()
                if n is None:
                    n = counts[0]
            t = t.head(max(n, floor))
            kept = t.capacity
            if other is not None:
                other = other.head(max(counts[-1], 1))
                kept += other.capacity
                args = (other,) + tuple(args[1:])
            rows_cut += before - kept
            attrs = getattr(sp, "attrs", None)  # None while spans are off
            if attrs is not None:
                attrs["kept"] = kept
        return t, n, args

    def _run_step(self, t: Table, step: str, args, cfg) -> Table:
        if step == "filter":
            col, op, value = args
            return filt_ops.filter_expr(t, col, op, value, config=cfg)
        if step == "filter_mask":
            (fn,) = args
            return filt_ops.filter_table(t, fn(t), config=cfg)
        if step == "select":
            (cols,) = args
            return t.select(cols)
        if step == "with_column":
            name, fn = args
            return t.with_columns(**{name: fn(t)})
        if step == "group_by":
            key, aggs = args
            return agg_ops.hash_aggregate(t, key, aggs, config=cfg)
        if step == "distinct":
            (col,) = args
            return agg_ops.distinct(t, col, config=cfg)
        if step == "top_k":
            col, k, largest = args
            return topk_ops.topk_table(t, col, k, largest=largest,
                                       config=cfg)
        if step == "limit":
            (n,) = args
            return t.head(n)
        if step == "join":
            other, on, max_dup, suffixes = args
            t, stats = join_ops.hash_join(
                t, other, on, max_duplicates=max_dup, suffixes=suffixes,
                config=cfg)
            self._stats["join"] = stats
            return t
        if step == "window":
            partition, order, specs = args
            return win_ops.table_window(t, partition, order, specs,
                                        config=cfg)
        if step == "sort_by":
            key, desc = args
            return _sort_table(t, key, desc, config=cfg)
        raise ValueError(step)  # pragma: no cover

    @property
    def last_stats(self):
        return dict(self._stats)
