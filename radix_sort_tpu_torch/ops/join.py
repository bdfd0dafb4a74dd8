"""Sort-merge inner join (build + probe) — BASELINE config 4.

Port of ``radix_sort_tpu/ops/join.py`` (``hash_join`` →
``_merge_scan_join``).  Build and probe rows are radix-sorted together by
their padded key (``sort.padded_key``) with one payload, the row id: build
row i is id i, probe row i is id B + i (int32, int64 once P + B reaches
2^31).  Whether a sorted row is real follows from its id alone, as
``Table.valid_mask()`` is ``arange < num_rows``.  Within each key run the
j-th build row's id is propagated forward onto the probe rows by a
segmented fill; the matched (probe id, build id) pairs are compacted to the
front by the radix kernels' stable pass, and each output column is gathered
once through them.  No table column rides the sort or the compaction.  The
JAX package's ``lax.associative_scan`` segmented scans become plain torch:
a cumulative sum minus its value at the run start, and the last seed
position at or before each row (scan.last_marked_index).

Output capacity is static (default probe capacity x ``max_duplicates``); a
larger true match count, or a key with more build rows than
``max_duplicates``, raises the ``overflow`` flag and truncates.  The rows
past the match count are padding whose contents are unspecified (each
gathers row 0 of its input); every caller reads ``[:num_rows]``.

Spans (``utils/profiling.span``): ``join.sort`` (the key, the ids and their
sort; attributes ``rows`` = P + B and ``bytes`` = the key's and the id's
bytes a row times the rows), ``join.match`` (run starts, segmented fills,
the candidates) and ``join.compact`` (attribute ``rows`` = P + B), and
``join.gather`` (the output columns; ``rows`` = the output capacity).
``sorted_rows`` counts the rows that entered a join's sort, ``sorted_bytes``
their key and payload bytes.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..table import Table
from ..utils import profiling
from . import partition
from . import sort as sort_ops
from .scan import last_marked_index

# Rows that entered the join's sort (probe and build capacity, padding
# included), and the bytes of their key and payload planes, over every
# join of the process; read as stream.host_reads is.
sorted_rows = 0
sorted_bytes = 0


def _gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col``'s rows at ``idx`` as bits (its container); zeros where the
    column has no row to read."""
    c = dtypes.as_container(col)
    out = (c.index_select(0, idx) if c.shape[0] else
           c.new_zeros(idx.shape[0]))
    return dtypes.from_container(out, col.dtype)


def _merge_scan_join(probe: Table, build: Table, key: str,
                     out_capacity: int, suffixes, max_duplicates: int = 1,
                     config: SortConfig = DEFAULT_CONFIG):
    """Inner join by one stable sort of key and row id, segmented fills,
    one compaction of id pairs and one gather a column.

    The JAX package sorts on (key, side) with side 0 for build rows.  Here
    the build rows come first in the id order, so a stable sort on the key
    alone already puts every build row of a key before its probe rows
    (padding included: build valid, build padding, probe valid, probe
    padding within the sentinel run), the same order as the two-key sort.
    Padding rows never match: their ids say they are padding, so real keys
    equal to the sentinel still match."""
    global sorted_rows, sorted_bytes
    D = max_duplicates
    P, B = probe.capacity, build.capacity
    n = P + B
    dev = probe.device
    id_dtype = torch.int32 if n < 2 ** 31 else torch.int64
    row_bytes = max(build[key].element_size(), 4) + id_dtype.itemsize
    sorted_rows += n
    sorted_bytes += n * row_bytes
    with profiling.span("join.sort", rows=n, bytes=n * row_bytes):
        keys_all = torch.cat([
            sort_ops.padded_key(build[key], build.valid_mask()),
            sort_ops.padded_key(probe[key], probe.valid_mask())])
        rid = torch.arange(n, dtype=id_dtype, device=dev)
        k_s, (rid_s,) = sort_ops.sort_biased_kv(keys_all, (rid,), config)

    with profiling.span("join.match", rows=n):
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = k_s[1:] != k_s[:-1]
        start = last_marked_index(is_start)
        pid = rid_s - B
        is_build = rid_s < build.num_rows
        is_probe_row = (pid >= 0) & (pid < probe.num_rows)

        # in-run index of each build row: the exclusive build count minus
        # its value at the run start
        excl = torch.cumsum(is_build, 0, dtype=torch.int32) - is_build.to(
            torch.int32)
        bidx = excl - excl[start]

        def run_ffill(seed_mask):
            """Index of the row whose id reaches each row: the last seed
            (unique per run) at or before it within its run, else the run
            start; and whether a seed was found."""
            src = last_marked_index(seed_mask | is_start)
            return seed_mask[src], src

        matched_j, bid_j = [], []
        for j in range(D):
            has_j, src_j = run_ffill(is_build & (bidx == j))
            matched_j.append(is_probe_row & has_j)
            bid_j.append(rid_s[src_j])
        if D < B:
            has_over, _ = run_ffill(is_build & (bidx == D))
            dup_overflow = (is_probe_row & has_over).any()
        else:
            dup_overflow = torch.zeros((), dtype=torch.bool, device=dev)

        # ---- emit: (n, D) candidates position-major
        def stack(per_j):
            if len(per_j) == 1:
                return per_j[0]
            return torch.stack(tuple(per_j), dim=1).reshape(-1)

        matched = stack(matched_j)
        n_match = matched.sum(dtype=torch.int32)

    with profiling.span("join.compact", rows=n):
        (pid_c, bid_c), _ = partition.compact_mask(
            matched, (stack([pid] * D), stack(bid_j)), method="auto",
            config=config)

    cap = min(out_capacity, n * D)
    with profiling.span("join.gather", rows=cap):
        # past the match count every row reads row 0: no index is out of
        # range and the padding's reads all hit one line
        real = torch.arange(cap, device=dev) < n_match
        pid_c = torch.where(real, pid_c[:cap], 0)
        bid_c = torch.where(real, bid_c[:cap], 0)
        out_cols = {}
        for nme in probe.column_names:
            out_cols[nme + suffixes[0]] = _gather(probe.columns[nme], pid_c)
        for nme in build.column_names:
            oname = nme + suffixes[1] if (nme + suffixes[0]) in out_cols \
                else nme
            out_cols[oname] = _gather(build.columns[nme], bid_c)
    stats = {"match_count": n_match,
             "overflow": (n_match > out_capacity) | dup_overflow}
    return Table(out_cols, num_rows=torch.clamp(n_match, max=out_capacity)
                 ), stats


def hash_join(probe: Table, build: Table, key: str,
              out_capacity: int | None = None,
              max_duplicates: int = 1,
              suffixes=("", "_r"),
              config: SortConfig = DEFAULT_CONFIG):
    """Inner join ``probe`` ⋈ ``build`` on column ``key``.

    ``max_duplicates`` bounds how many build rows may share one key;
    output capacity defaults to ``probe.capacity * max_duplicates``.

    Returns ``(table, stats)``; stats holds 0-d device tensors
    ``match_count`` (int32) and ``overflow`` (bool: the match count exceeded
    capacity, or a key's build run exceeded max_duplicates)."""
    if out_capacity is None:
        out_capacity = probe.capacity * max_duplicates
    pk, bk = probe[key], build[key]
    if pk.dtype != bk.dtype:
        raise ValueError(f"join key dtypes differ: {pk.dtype} vs {bk.dtype}")
    return _merge_scan_join(probe, build, key, out_capacity, suffixes,
                            max_duplicates=max_duplicates, config=config)
