"""Hash aggregate (GROUP BY) — BASELINE config 3.

Port of ``radix_sort_tpu/ops/aggregate.py``.  Aggregation is sort-based:
rows are radix-sorted by the group key, runs of equal keys are reduced, and
``num_rows`` carries the group count.  Groups come out in ascending key
order.

``method="scan"`` compacts the run-end rows to the front:

  - count and integer sum/mean: a cumulative sum in the column's own width
    (wrapping like the JAX int32 cumsum), read at run ends, differenced
    after compaction.
  - float sum/mean and min/max: the segmented scan below, read at run
    ends, as the JAX package's segmented ``associative_scan``.  The two
    scans add a group's floats in different orders (and the JAX sort is
    unstable), so float sums agree to rounding, not bit for bit.
  - the compaction of run ends: one stable pass of the radix kernels
    (partition.compact_mask, method="auto").

``method="segment"`` is the JAX package's scatter-based cross-check: each
aggregation reduces the sorted rows into segment ids with ``index_add_`` /
``scatter_reduce_`` (``jax.ops.segment_*`` there), padding into the last
segment, and empty segments hold the reduction's identity.

``_segmented_scan`` is the JAX package's segmented ``associative_scan``
(the window functions use it) without ``torch.cummax``/``cummin``, which
were the slowest step of a join on the card: forward fills gather from each
run's first row (scan.last_marked_index), integer sums are a cumulative sum
minus its value before the run, and min, max and float sums are a log-step
doubling scan that restarts at every run, as the JAX comment asks for float
precision (in two levels: 10 steps inside blocks of 1024 rows, then the
blocks' last values, in place of 26 steps over 2^26 rows).
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..table import Table
from . import partition
from . import sort as sort_ops
from .scan import last_marked_index

AGG_OPS = ("count", "sum", "min", "max", "mean")
METHODS = ("scan", "segment")
SCAN_OPS = ("add", "min", "max", "first")
_COMBINE = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


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


def run_starts(is_new: torch.Tensor):
    """For every row, the index of the first row of its run (int64) and
    its position in the run (int32).  Row 0 starts a run whatever
    ``is_new[0]`` says, as in the JAX scan."""
    mark = is_new.clone()
    mark[:1] = True
    start = last_marked_index(mark)
    pos = torch.arange(mark.shape[0], device=mark.device) - start
    return start, pos.to(torch.int32)


SCAN_BLOCK = 1024


def _doubling_steps(v: torch.Tensor, pos: torch.Tensor, combine):
    """Inclusive scan along the last dimension of ``v`` by ``combine`` that
    restarts where ``pos`` (the row's position in its run) is 0: at step d
    row i takes in row i - d when that row is in its run, so after the
    step each row holds the reduction of its last 2d rows in the run."""
    m = v.shape[-1]
    d = 1
    while d < m:
        nxt = torch.empty_like(v)
        nxt[..., :d] = v[..., :d]
        torch.where(pos[..., d:] >= d, combine(v[..., :-d], v[..., d:]),
                    v[..., d:], out=nxt[..., d:])
        v, d = nxt, 2 * d
    return v


def _doubling_scan(v: torch.Tensor, pos: torch.Tensor, combine):
    """:func:`_doubling_steps` over a 1-D ``v`` in two levels: log2(block)
    steps inside blocks of SCAN_BLOCK rows, the same scan over the blocks'
    last values (a block continues the one before when its last row's run
    began there), and one step that combines the scan's value at the end
    of the block before into each row whose run began before its block.
    A run's rows are still reduced only with each other."""
    n = v.shape[0]
    block = SCAN_BLOCK
    if n <= block:
        return _doubling_steps(v, pos, combine)
    nb = -(-n // block)
    if nb * block != n:  # tail rows, each a run of its own
        v = torch.cat([v, v.new_zeros(nb * block - n)])
        pos = torch.cat([pos, pos.new_zeros(nb * block - n)])
    local = _doubling_steps(v.view(nb, block), pos.view(nb, block), combine)
    p2 = pos.view(nb, block)
    carried = p2 > torch.arange(block, device=v.device)
    # blocks back to the one where the run of the block's last row began
    last = torch.arange(nb, device=v.device) * block + block - 1
    back = torch.arange(nb, device=v.device) - (last - p2[:, -1]) // block
    ends = _doubling_steps(local[:, -1], back, combine)
    before = torch.cat([ends[:1], ends[:-1]])[:, None]  # block 0: unused
    out = torch.where(carried, combine(before, local), local)
    return out.view(-1)[:n]


def _segmented_scan(vals: torch.Tensor, is_new: torch.Tensor, op: str,
                    runs=None) -> torch.Tensor:
    """Inclusive scan of ``vals`` that restarts at every row whose
    ``is_new`` is set; ``op`` is "add", "min", "max" or "first" (keep the
    run's first value).  Integers keep their dtype and wrap like the JAX
    scan; ``runs`` is :func:`run_starts` of ``is_new`` where the caller has
    it."""
    if op not in SCAN_OPS:
        raise ValueError(f"unknown scan op {op!r}")
    if vals.shape[0] == 0:
        return vals
    start, pos = run_starts(is_new) if runs is None else runs
    logical = vals.dtype
    v = dtypes.as_container(vals)
    if op == "first":
        return dtypes.from_container(torch.index_select(v, 0, start), logical)
    narrow = not v.dtype.is_floating_point and v.element_size() < 4
    if narrow:  # 8- and 16-bit ints widen; the result narrows back exactly
        v = v.to(torch.int32)
    if op == "add" and not v.dtype.is_floating_point:
        # the wraparound makes the difference exact modulo 2^width
        c = torch.cumsum(v, 0, dtype=v.dtype)
        out = c - torch.index_select(c - v, 0, start)
    else:
        flip = v.dtype != logical and dtypes.is_unsigned(logical)
        if flip:  # min/max of uint32/uint64 in unsigned order
            v = dtypes.signed_order(v)
        out = _doubling_scan(v, pos, _COMBINE[op])
        if flip:
            out = dtypes.signed_order(out)
    if narrow:
        out = out.to(logical)
    return dtypes.from_container(out, logical)


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
    if method not in METHODS:
        raise ValueError(f"unknown aggregate method {method!r}")
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
    if method == "segment":
        return _hash_aggregate_segment(table, key, aggs, ku_sorted, payload,
                                       valid, is_new)
    run_end = valid & torch.cat([differs | ~valid[1:], true1])
    num_groups = is_new.sum(dtype=torch.int32)
    count_cum = torch.cumsum(valid, 0, dtype=torch.int32)
    runs = []  # run_starts(is_new), made by the first scan that needs it

    def scan(z, op):
        if not runs:
            runs.append(run_starts(is_new))
        return _segmented_scan(z, is_new, op, runs[0])

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
                # per-group restart keeps float precision local
                end_cols[out_name] = scan(z, "add")
            else:
                # the integer wraparound makes the cumsum difference exact
                # modulo 2^width
                end_cols[out_name] = torch.cumsum(z, 0, dtype=z.dtype)
                diff_cols.add(out_name)
            if op == "mean":
                end_cols[out_name + "__cnt__"] = count_cum
                diff_cols.add(out_name + "__cnt__")
        else:
            flip = v.dtype != payload[col].dtype
            if flip:  # uint32/uint64: reduce in unsigned order
                v = dtypes.signed_order(v)
            z = torch.where(valid, v, _type_extreme(v.dtype, op == "min"))
            r = scan(z, op)
            end_cols[out_name] = dtypes.signed_order(r) if flip else r

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


# ---- scatter-based reference formulation (method="segment") --------------

def _segment_mean_dtype(dtype: torch.dtype) -> torch.dtype:
    """The JAX result type of ``sum / max(count, 1)`` with the count in the
    column's own dtype: floats keep theirs, 8-byte ints give float64, the
    other ints float32."""
    if dtype.is_floating_point:
        return dtype
    return torch.float64 if dtype.itemsize == 8 else torch.float32


def _segment_reduce(op: str, vals, seg: torch.Tensor, num_segments: int,
                    valid: torch.Tensor) -> torch.Tensor:
    """One aggregation of the sorted rows into ``num_segments`` segments,
    as ``jax.ops.segment_sum/min/max`` compute it."""
    if op == "count":
        return torch.zeros(num_segments, dtype=torch.int32,
                           device=seg.device).index_add_(
            0, seg, valid.to(torch.int32))
    logical = vals.dtype
    v = dtypes.as_container(vals)
    if op in ("sum", "mean"):
        s = v.new_zeros(num_segments).index_add_(0, seg,
                                                 torch.where(valid, v, 0))
        if op == "sum":
            return dtypes.from_container(s, logical)
        c = v.new_zeros(num_segments).index_add_(0, seg, valid.to(v.dtype))
        fd = _segment_mean_dtype(logical)
        return (_as_float(s, fd, logical)
                / _as_float(c.clamp_min(1), fd, logical))
    flip = v.dtype != logical  # uint32/uint64: reduce in unsigned order
    if flip:
        v = dtypes.signed_order(v)
    identity = _type_extreme(v.dtype, op == "min")
    r = torch.full((num_segments,), identity, dtype=v.dtype,
                   device=v.device).scatter_reduce_(
        0, seg, torch.where(valid, v, identity),
        "amin" if op == "min" else "amax")
    return dtypes.from_container(dtypes.signed_order(r) if flip else r,
                                 logical)


def _hash_aggregate_segment(table: Table, key: str, aggs, ku_sorted,
                            payload, valid, is_new) -> Table:
    """GROUP BY over the sorted rows by segment reductions.  Group g is
    segment g; padding rows go to the last segment, which no group reaches
    when there is padding; the group key is the segment max of the
    run-start keys (in unsigned order)."""
    cap = table.capacity
    seg = torch.cumsum(is_new, 0) - 1
    seg = torch.where(valid, seg, cap - 1)
    starts = dtypes.signed_order(torch.where(is_new, ku_sorted, 0))
    group_keys = torch.full((cap,), dtypes.sign_bit(8 * starts.element_size()),
                            dtype=starts.dtype, device=starts.device)
    group_keys.scatter_reduce_(0, seg, starts, "amax")
    out_cols = {key: dtypes.from_sortable(dtypes.signed_order(group_keys),
                                          table[key].dtype)}
    for out_name, (op, col) in aggs.items():
        vals = payload[col] if col is not None else ku_sorted
        out_cols[out_name] = _segment_reduce(op, vals, seg, cap, valid)
    return Table(out_cols, num_rows=is_new.sum(dtype=torch.int32))
