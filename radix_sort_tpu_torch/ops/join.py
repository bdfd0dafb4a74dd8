"""Sort-merge inner join (build + probe) — BASELINE config 4.

Port of ``radix_sort_tpu/ops/join.py`` (``hash_join`` →
``_merge_scan_join``).  Build and probe rows are radix-sorted together by
key, every column riding as payload; within each key run the j-th build row
is propagated forward onto the probe rows by a segmented fill; the matched
(probe, build) candidates are compacted to the front by the radix kernels'
stable pass.  The JAX package's ``lax.associative_scan`` segmented scans
become plain torch: a cumulative sum minus its value at the run start, and
the last seed position at or before each row (scan.last_marked_index).

Output capacity is static (default probe capacity x ``max_duplicates``); a
larger true match count, or a key with more build rows than
``max_duplicates``, raises the ``overflow`` flag and truncates.

Spans (``utils/profiling.span``, attribute ``rows`` = P + B): ``join.sort``
(the operands and their sort), ``join.match`` (run starts, segmented
fills, build-column gathers, the candidates) and ``join.compact``.
``sorted_rows`` counts the rows that entered a join's sort.
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
# included), over every join of the process; read as stream.host_reads is.
sorted_rows = 0


def _merge_scan_join(probe: Table, build: Table, key: str,
                     out_capacity: int, suffixes, max_duplicates: int = 1,
                     config: SortConfig = DEFAULT_CONFIG):
    """Inner join by one stable sort, segmented fills and one compaction.

    The JAX package sorts on (key, side) with side 0 for build rows.  Here
    the build rows come first in the concatenation, so a stable sort on the
    key alone already puts every build row of a key before its probe rows
    (padding included: build valid, build padding, probe valid, probe
    padding within the sentinel run), the same order as the two-key sort.
    Padding rows never match (sentinel keys + validity)."""
    global sorted_rows
    D = max_duplicates
    P, B = probe.capacity, build.capacity
    n = P + B
    sorted_rows += n
    dev = probe.device
    b_names, p_names = build.column_names, probe.column_names
    with profiling.span("join.sort", rows=n):
        keys_all = torch.cat([
            sort_ops.padded_key(build[key], build.valid_mask()),
            sort_ops.padded_key(probe[key], probe.valid_mask())])
        side = torch.cat([torch.zeros(B, dtype=torch.int32, device=dev),
                          torch.ones(P, dtype=torch.int32, device=dev)])
        zb = torch.zeros(B, dtype=torch.bool, device=dev)
        zp = torch.zeros(P, dtype=torch.bool, device=dev)
        build_valid = torch.cat([build.valid_mask(), zp])
        probe_valid = torch.cat([zb, probe.valid_mask()])

        operands = [side, build_valid, probe_valid]
        for nme in b_names:
            c = dtypes.as_container(build.columns[nme])
            operands.append(torch.cat([c, c.new_zeros(P)]))
        for nme in p_names:
            c = dtypes.as_container(probe.columns[nme])
            operands.append(torch.cat([c.new_zeros(B), c]))
        k_s, out = sort_ops.sort_biased_kv(keys_all, operands, config)
    side_s, bval_s, pval_s = out[0], out[1], out[2]
    b_cols_s = out[3:3 + len(b_names)]
    p_cols_s = dict(zip(p_names, out[3 + len(b_names):]))

    with profiling.span("join.match", rows=n):
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = k_s[1:] != k_s[:-1]
        start = last_marked_index(is_start)
        is_build = (side_s == 0) & bval_s
        is_probe_row = (side_s == 1) & pval_s

        # in-run index of each build row: the exclusive build count minus
        # its value at the run start
        excl = torch.cumsum(is_build, 0, dtype=torch.int32) - is_build.to(
            torch.int32)
        bidx = excl - excl[start]

        def run_ffill(seed_mask):
            """Index of the row whose payload reaches each row: the last
            seed (unique per run) at or before it within its run, else the
            run start; and whether a seed was found."""
            src = last_marked_index(seed_mask | is_start)
            return seed_mask[src], src

        matched_cols = []
        for j in range(D):
            has_j, src_j = run_ffill(is_build & (bidx == j))
            matched_cols.append((is_probe_row & has_j,
                                 tuple(c[src_j] for c in b_cols_s)))
        if D < B:
            has_over, _ = run_ffill(is_build & (bidx == D))
            dup_overflow = (is_probe_row & has_over).any()
        else:
            dup_overflow = torch.zeros((), dtype=torch.bool, device=dev)

        # ---- emit: (n, D) candidates position-major
        def stack(per_j):
            return torch.stack(tuple(per_j), dim=1).reshape(-1)

        matched = stack(m for m, _ in matched_cols)
        names_out, vals_out, dtypes_out = [], [], []
        for nme in p_names:
            names_out.append(nme + suffixes[0])
            vals_out.append(stack([p_cols_s[nme]] * D))
            dtypes_out.append(probe.columns[nme].dtype)
        for i, nme in enumerate(b_names):
            oname = nme + suffixes[1] if (nme + suffixes[0]) in names_out \
                else nme
            names_out.append(oname)
            vals_out.append(stack(mc[1][i] for mc in matched_cols))
            dtypes_out.append(build.columns[nme].dtype)
        n_match = matched.sum(dtype=torch.int32)

    with profiling.span("join.compact", rows=n):
        packed, _ = partition.compact_mask(matched, tuple(vals_out),
                                           method="auto", config=config)
        out_cols = {nm: dtypes.from_container(v[:out_capacity], dt)
                    for nm, v, dt in zip(names_out, packed, dtypes_out)}
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
