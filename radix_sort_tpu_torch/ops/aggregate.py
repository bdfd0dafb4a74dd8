"""Hash aggregate (GROUP BY) — BASELINE config 3.

Port of ``radix_sort_tpu/ops/aggregate.py`` (``method="scan"``; the
scatter-based ``"segment"`` cross-check waits).  Aggregation is sort-based:
rows are radix-sorted by the group key, runs of equal keys are reduced, and
the run-end rows are compacted to the front.  Groups come out in
ascending key order; ``num_rows`` carries the group count.

  - count and integer sum/mean: a cumulative sum in the column's own width
    (wrapping like the JAX int32 cumsum), read at run ends, differenced
    after compaction.
  - float sum/mean and min/max: a per-group reduction over the group ids
    (``scatter_reduce``) gathered back to the rows.  The JAX package sums
    floats with a segmented ``associative_scan`` after an unstable sort, so
    float sums agree to rounding, not bit for bit.
  - the compaction of run ends: one stable pass of the radix kernels
    (partition.compact_mask, method="auto").
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from ..table import Table
from . import partition
from . import sort as sort_ops

AGG_OPS = ("count", "sum", "min", "max", "mean")


def _type_extreme(dtype: torch.dtype, max_side: bool):
    if dtype.is_floating_point:
        return float("inf") if max_side else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if max_side else info.min


def _mean_dtype(dtype: torch.dtype) -> torch.dtype:
    """The JAX result type of ``sum / max(count, 1)`` with an int32 count:
    floats keep their type, ints up to 32 bits signed give float32, wider
    or unsigned 32-bit ones (promoted to int64 with int32) give float64."""
    if dtype.is_floating_point:
        return dtype
    if dtype in (torch.int8, torch.int16, torch.int32, torch.uint8,
                 torch.uint16, torch.bool):
        return torch.float32
    return torch.float64


def _as_float(x: torch.Tensor, dtype: torch.dtype,
              logical: torch.dtype) -> torch.Tensor:
    """Container values of logical dtype ``logical`` → float ``dtype``."""
    if logical == torch.uint32:
        return (x.to(torch.int64) & 0xFFFFFFFF).to(dtype)
    if logical == torch.uint64:
        # both halves convert exactly, so the sum rounds once, as a direct
        # uint64 -> float64 conversion does
        hi = ((x >> 32) & 0xFFFFFFFF).to(dtype)
        return hi * 2.0 ** 32 + (x & 0xFFFFFFFF).to(dtype)
    return x.to(dtype)


def _group_reduce(vals: torch.Tensor, group: torch.Tensor,
                  reduce: str) -> torch.Tensor:
    """Per-row value of its group's ``reduce`` ("sum", "amin", "amax")."""
    out = torch.zeros_like(vals).scatter_reduce_(0, group, vals, reduce,
                                                 include_self=False)
    return out[group]


def _sorted_rows(table: Table, key: str, needed_cols, config: SortConfig):
    """Stable radix sort of the rows by the sortable key, padding rows
    carrying the max sentinel.  Returns (sorted key bits, sorted payload
    dict, validity of the sorted rows).

    The JAX package sorts on (key, invalid) with an unstable network so
    that padding never lands among real keys equal to the sentinel.  A
    stable sort on the key alone gives that order already: the valid rows
    are the Table's prefix, so every real row precedes every padding row
    within the sentinel run, and the valid rows stay the sorted prefix of
    num_rows rows."""
    valid_in = table.valid_mask()
    ku = torch.where(valid_in, dtypes.to_sortable(table[key]),
                     dtypes.SENTINEL_BITS)
    names = tuple(sorted(needed_cols))
    ku_sorted, cols = sort_ops.sort_biased_kv(
        ku, tuple(table[c] for c in names), config)
    return ku_sorted, dict(zip(names, cols)), valid_in


def hash_aggregate(table: Table, key: str,
                   aggs: Mapping[str, Tuple[str, str | None]],
                   config: SortConfig = DEFAULT_CONFIG,
                   method: str = "scan") -> Table:
    """GROUP BY ``key`` with aggregations ``aggs`` (out_name -> (op, col);
    col may be None for "count")."""
    for out_name, (op, _) in aggs.items():
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregation {op!r} for {out_name!r}")
    if method != "scan":
        raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                          f"aggregate method {method!r} is not yet ported")
    cap = table.capacity
    dev = table.device
    if cap == 0:
        return Table({key: table[key],
                      **{n: torch.zeros(0, dtype=torch.int32, device=dev)
                         for n in aggs}}, num_rows=0)

    needed_cols = sorted({c for (_, c) in aggs.values() if c is not None})
    ku_sorted, payload, valid = _sorted_rows(table, key, needed_cols, config)

    differs = ku_sorted[1:] != ku_sorted[:-1]
    true1 = torch.ones(1, dtype=torch.bool, device=dev)
    is_new = valid & torch.cat([true1, differs])
    run_end = valid & torch.cat([differs | ~valid[1:], true1])
    num_groups = is_new.sum(dtype=torch.int32)
    group = (torch.cumsum(is_new, 0) - 1).clamp_min(0)
    count_cum = torch.cumsum(valid, 0, dtype=torch.int32)

    end_cols = {"__key__": ku_sorted}
    diff_cols = set()
    for out_name, (op, col) in aggs.items():
        if op == "count":
            end_cols[out_name] = count_cum
            diff_cols.add(out_name)
            continue
        v = dtypes.as_container(payload[col])
        if op in ("sum", "mean"):
            z = torch.where(valid, v, 0)
            if v.dtype.is_floating_point:
                end_cols[out_name] = _group_reduce(z, group, "sum")
            else:
                # the integer wraparound makes the cumsum difference exact
                # modulo 2^width
                end_cols[out_name] = torch.cumsum(z, 0, dtype=z.dtype)
                diff_cols.add(out_name)
            if op == "mean":
                end_cols[out_name + "__cnt__"] = count_cum
                diff_cols.add(out_name + "__cnt__")
        else:
            unsigned = dtypes.is_unsigned(payload[col].dtype)
            if unsigned:  # reduce in unsigned order
                v = dtypes.signed_order(v)
            z = torch.where(valid, v, _type_extreme(v.dtype, op == "min"))
            r = _group_reduce(z, group, "amin" if op == "min" else "amax")
            end_cols[out_name] = dtypes.signed_order(r) if unsigned else r

    names = sorted(end_cols)
    packed, _ = partition.compact_mask(
        run_end, tuple(end_cols[n] for n in names), method="auto",
        config=config)
    compacted = dict(zip(names, packed))

    def finalize(name):
        c = compacted[name]
        if name in diff_cols:
            return c - torch.cat([c.new_zeros(1), c[:-1]])
        return c

    out_cols = {key: dtypes.from_sortable(compacted["__key__"],
                                          table[key].dtype)}
    for out_name, (op, col) in aggs.items():
        if op == "count":
            out_cols[out_name] = finalize(out_name)
            continue
        logical = table[col].dtype
        if op == "mean":
            fd = _mean_dtype(logical)
            s = _as_float(finalize(out_name), fd, logical)
            cnt = finalize(out_name + "__cnt__").clamp_min(1).to(fd)
            out_cols[out_name] = s / cnt
        else:
            out_cols[out_name] = dtypes.from_container(finalize(out_name),
                                                       logical)
    return Table(out_cols, num_rows=num_groups)


def distinct(table: Table, key: str,
             config: SortConfig = DEFAULT_CONFIG) -> Table:
    """SELECT DISTINCT ON (key): one row per distinct key value — the FIRST
    occurrence's full row — in ascending key order.  One stable radix sort
    of every column by the sortable key (stability gives first-occurrence
    semantics, and keeps real sentinel-valued keys ahead of padding), run
    starts, then their compaction by the radix kernels' stable pass."""
    cap = table.capacity
    if cap == 0:
        return Table(dict(table.columns), num_rows=0)
    valid = table.valid_mask()
    ku = torch.where(valid, dtypes.to_sortable(table[key]),
                     dtypes.SENTINEL_BITS)
    names = table.column_names
    ku_sorted, cols_sorted = sort_ops.sort_biased_kv(
        ku, tuple(table.columns[n] for n in names), config)
    true1 = torch.ones(1, dtype=torch.bool, device=table.device)
    is_new = valid & torch.cat([true1, ku_sorted[1:] != ku_sorted[:-1]])
    packed, num_distinct = partition.compact_mask(is_new, cols_sorted,
                                                  method="auto", config=config)
    return Table(dict(zip(names, packed)), num_rows=num_distinct)
