"""Window (analytic) functions and segmented sort.

Port of ``radix_sort_tpu/ops/window.py``: ROW_NUMBER / RANK / DENSE_RANK,
running count / sum / min / max, FIRST_VALUE and LAG / LEAD over
(PARTITION BY, ORDER BY), and a segmented sort, with the JAX package's
contract: rows are ordered by (validity, partition, order, input
position), every output is a run-boundary mask plus a segmented scan in
that order, and the results come back in input order.

The JAX package orders the rows with one unstable 4-key ``lax.sort`` whose
last key is the row index, and returns with a second sort keyed on the
permutation.  Here the order is built from stable passes, least
significant key first: the engine's radix sort by the order key, then by
the partition key (stability stands in for the index key), then, when a
validity mask is given, one two-bucket stable partition that moves the
invalid rows behind the valid ones.  The permutation rides along as an
int32 payload beside the keys; the value columns are gathered by it once,
and the results go back to input order by gathers through its inverse,
which one scatter makes.

Rows that ``valid`` masks (any mask, not only a padding tail) form
trailing partitions of their own, ordered like the valid ones, so they
never change a valid row's result, and their own results equal the JAX
package's.  Partition and tie boundaries compare sortable bits, so -0.0
and +0.0 are different partitions, as there.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
from torch.utils import _pytree as pytree

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from ..table import Table
from . import partition
from . import sort as sort_ops
from .aggregate import _segmented_scan, run_starts


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (int64 ``idx``), uint16/32/64 through their containers."""
    return dtypes.from_container(
        torch.index_select(dtypes.as_container(x), 0, idx), x.dtype)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation, int64: ``inv[perm[i]] = i``."""
    inv = torch.empty(perm.shape[0], dtype=torch.int64, device=perm.device)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _lex_sort(keys, config: SortConfig, valid: torch.Tensor | None = None):
    """Stable lexicographic order of the rows by ``keys``, a sequence of
    (sortable bits, key width) pairs, most significant first, with the
    rows whose ``valid`` is False after all the others.

    Returns (the sorted bits of each key, the permutation as int32, the
    number of valid rows as a 0-d tensor or None)."""
    bits = [b for b, _ in keys]
    perm = torch.arange(bits[0].shape[0], dtype=torch.int32,
                        device=bits[0].device)
    for i in reversed(range(len(bits))):
        others = tuple(bits[:i] + bits[i + 1:])
        key_i, outs = sort_ops.sort_biased_kv(bits[i], others + (perm,),
                                              config, keys[i][1])
        bits = list(outs[:i]) + [key_i] + list(outs[i:-1])
        perm = outs[-1]
    if valid is None:
        return bits, perm, None
    packed, kept = partition.compact_mask(
        valid.to(torch.bool)[perm.long()], tuple(bits) + (perm,),
        method="stream", config=config)
    return list(packed[:-1]), packed[-1], kept


def _boundary(bits: torch.Tensor) -> torch.Tensor:
    """True where a row's bits differ from the row before; row 0 True."""
    head = torch.ones(1, dtype=torch.bool, device=bits.device)
    return torch.cat([head, bits[1:] != bits[:-1]])


def _shift(x: torch.Tensor, k: int, fill, right: bool) -> torch.Tensor:
    """x moved k rows toward higher (``right``) or lower indices, the
    vacated rows set to ``fill``."""
    n = x.shape[0]
    k = min(k, n)
    pad = torch.full((k,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:n - k]] if right else [x[k:], pad])


def _container_fill(fill, dtype: torch.dtype):
    """``fill`` as a value of the container of ``dtype`` (the bit pattern
    of an unsigned 16/32/64-bit fill in its signed container)."""
    if dtypes.container_dtype(dtype) != dtype:
        width = dtypes.key_bits(dtype)
        v = int(fill) & ((1 << width) - 1)
        return v - (1 << width) if v >> (width - 1) else v
    return fill


# ---------------------------------------------------------------------------
# segmented sort
# ---------------------------------------------------------------------------

def segmented_sort_kv(seg_ids: torch.Tensor, keys: torch.Tensor,
                      values: Any = None,
                      config: SortConfig = DEFAULT_CONFIG):
    """Sort ``keys`` (stably, ascending) within each segment of a
    non-decreasing ``seg_ids`` column; the segment layout is unchanged.

    One lexicographic (segment, key, position) order over the whole array:
    a stable sort by the key, then by the segment id.  ``values`` is a
    pytree of 1-D tensors gathered by the resulting permutation.

    Returns ``(sorted_keys, sorted_values)`` (``sorted_values`` is None
    when ``values`` is None)."""
    n = keys.shape[0]
    if seg_ids.shape[0] != n:
        raise EngineError(
            OperationStatus.HOST_BUFFERS_FAILED,
            f"seg_ids length {seg_ids.shape[0]} != keys {n}")
    leaves, spec = pytree.tree_flatten(() if values is None else values)
    for leaf in leaves:
        if leaf.shape[0] != n:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"value leaf length {leaf.shape[0]} != keys {n}")
    (_, ks), perm, _ = _lex_sort(
        ((dtypes.to_sortable(seg_ids), dtypes.key_bits(seg_ids.dtype)),
         (dtypes.to_sortable(keys), dtypes.key_bits(keys.dtype))), config)
    sorted_keys = dtypes.from_sortable(ks, keys.dtype)
    if values is None:
        return sorted_keys, None
    idx = perm.long()
    return sorted_keys, pytree.tree_unflatten(
        [_gather(leaf, idx) for leaf in leaves], spec)


def segmented_sort(seg_ids: torch.Tensor, keys: torch.Tensor,
                   config: SortConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Key-only :func:`segmented_sort_kv`."""
    out, _ = segmented_sort_kv(seg_ids, keys, None, config)
    return out


# ---------------------------------------------------------------------------
# window functions
# ---------------------------------------------------------------------------

#: spec kinds by the operands they take from the spec tuple
_ZERO_ARG = ("row_number", "rank", "dense_rank", "cum_count")
_COL_ARG = ("cum_sum", "cum_min", "cum_max", "first_value")
_SHIFT_ARG = ("lag", "lead")
_COL_SCAN = {"cum_sum": "add", "cum_min": "min", "cum_max": "max",
             "first_value": "first"}


def _normalize_spec(name, spec):
    if isinstance(spec, str):
        spec = (spec,)
    kind = spec[0]
    if kind in _ZERO_ARG:
        if len(spec) != 1:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: {kind} takes no args")
        return (kind,)
    if kind in _COL_ARG:
        if len(spec) != 2:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: {kind} takes (col,)")
        return (kind, spec[1])
    if kind in _SHIFT_ARG:
        if len(spec) < 2 or len(spec) > 4:
            raise EngineError(
                OperationStatus.INITIALIZATION_FAILED,
                f"window spec {name}: {kind} takes (col[, offset[, fill]])")
        col = spec[1]
        offset = int(spec[2]) if len(spec) > 2 else 1
        fill = spec[3] if len(spec) > 3 else 0
        if offset < 1:
            raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                              f"window spec {name}: offset must be >= 1")
        return (kind, col, offset, fill)
    raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                      f"window spec {name}: unknown kind {kind!r}")


def window(partition: torch.Tensor, order: torch.Tensor,
           specs: Mapping[str, tuple],
           columns: Mapping[str, torch.Tensor] | None = None,
           valid: torch.Tensor | None = None,
           config: SortConfig = DEFAULT_CONFIG) -> dict:
    """Compute a batch of window outputs over (PARTITION BY ``partition``,
    ORDER BY ``order`` ascending), all from one ordering of the rows.

    ``specs`` maps output name → spec tuple:
      ``("row_number",)``            1-based position within partition
      ``("rank",)``                  SQL RANK (ties share, gaps after)
      ``("dense_rank",)``            SQL DENSE_RANK (ties share, no gaps)
      ``("cum_count",)``             alias of row_number
      ``("cum_sum", col)``           running sum of ``columns[col]``
      ``("cum_min", col)`` / ``("cum_max", col)``
      ``("first_value", col)``       partition-first value in order
      ``("lag", col[, k[, fill]])``  value k rows earlier in the partition
      ``("lead", col[, k[, fill]])`` value k rows later

    ``valid`` (optional bool mask) demotes masked rows to trailing
    partitions of their own.  Results are aligned to the INPUT row order;
    counts and ranks are int32, the rest keep their column's dtype."""
    n = partition.shape[0]
    specs = {name: _normalize_spec(name, s) for name, s in specs.items()}
    columns = dict(columns or {})
    needed = sorted({s[1] for s in specs.values() if len(s) > 1})
    for c in needed:
        if c not in columns:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              f"window: spec references missing column {c!r}")
        if columns[c].shape[0] != n:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"window: column {c!r} length {columns[c].shape[0]} != {n}")
    if n == 0:
        return {name: torch.zeros(0, dtype=(columns[s[1]].dtype if len(s) > 1
                                            else torch.int32),
                                  device=partition.device)
                for name, s in specs.items()}

    (pu_s, ou_s), perm, kept = _lex_sort(
        ((dtypes.to_sortable(partition), dtypes.key_bits(partition.dtype)),
         (dtypes.to_sortable(order), dtypes.key_bits(order.dtype))),
        config, valid)
    idx = perm.long()
    cols_s = {c: _gather(columns[c], idx) for c in needed}

    part_new = _boundary(pu_s)
    if kept is not None:  # the first masked row opens a partition
        part_new |= torch.arange(n, device=pu_s.device) == kept
    order_new = part_new | _boundary(ou_s)
    runs = run_starts(part_new)
    rn = runs[1] + 1  # 1-based row number, int32

    results = []
    for name, s in specs.items():
        kind = s[0]
        if kind in ("row_number", "cum_count"):
            r = rn
        elif kind == "rank":
            # the row number at the start of each tie run
            r = _segmented_scan(rn, order_new, "first")
        elif kind == "dense_rank":
            r = _segmented_scan(order_new.to(torch.int32), part_new, "add",
                                runs)
        elif kind in _COL_SCAN:
            r = _segmented_scan(cols_s[s[1]], part_new, _COL_SCAN[kind],
                                runs)
        else:  # lag / lead
            _, col, k, fill = s
            v = dtypes.as_container(cols_s[col])
            fill = _container_fill(fill, cols_s[col].dtype)
            if kind == "lag":
                shifted = _shift(v, k, fill, right=True)
                in_seg = rn > k
            else:
                shifted = _shift(v, k, fill, right=False)
                # row i+k is in the same partition iff no boundary opened
                # in (i, i+k]: compare partition run ids k apart
                run_id = torch.cumsum(part_new, 0, dtype=torch.int32)
                in_seg = _shift(run_id, k, -1, right=False) == run_id
            r = dtypes.from_container(
                torch.where(in_seg, shifted, torch.full_like(v, fill)),
                cols_s[col].dtype)
        results.append(r)

    # back to input order: perm is a permutation, so its inverse (one
    # scatter) gathers every result exactly
    inv = _inverse(idx)
    return {name: _gather(r, inv) for name, r in zip(specs, results)}


def table_window(table: Table, partition: str, order: str,
                 specs: Mapping[str, tuple],
                 config: SortConfig = DEFAULT_CONFIG) -> Table:
    """:func:`window` over a :class:`Table`: appends one column per spec.

    Padding rows (beyond ``num_rows``) are isolated into their own trailing
    partitions via the validity mask, so tail garbage equal to a live
    partition key cannot change the results of real rows."""
    specs_n = {name: _normalize_spec(name, s) for name, s in specs.items()}
    needed = {s[1] for s in specs_n.values() if len(s) > 1}
    cols = {c: table[c] for c in needed}
    out = window(table[partition], table[order], specs_n, cols,
                 valid=table.valid_mask(), config=config)
    return table.with_columns(**out)
