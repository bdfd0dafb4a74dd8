"""Distributed query operators: hash-partitioned aggregate and join, top-k.

Port of ``radix_sort_tpu/parallel/dist_ops.py`` (BASELINE config 5).  Each
rank holds its rows as a :class:`~radix_sort_tpu_torch.table.Table`
(``shard_table`` cuts a global table as ``mesh.shard_1d`` cuts an array);
rows are re-partitioned by a multiplicative hash of the key, so every
equal key lands on one rank, and the single-card operators
(ops/aggregate.py, ops/join.py) run on each rank.  The shuffle is the
exact ragged exchange of exchange.py, in hash sub-chunks: sub-chunk g + 1
is on the wire while g aggregates or joins, and equal keys share a
sub-chunk, so the per-chunk results concatenate.

Results are a :class:`ShardedTable`: each rank's result rows;
``to_numpy`` gathers them in rank order, as the JAX one does.  The hash,
the sub-chunk order and the stitch order are the JAX package's, so
``to_numpy`` equals the JAX result row for row.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..ops import aggregate as agg_ops, join as join_ops, partition
from ..ops import sort as sort_ops, stream, topk as topk_ops
from ..table import Table
from . import exchange, mesh as mesh_lib

_GOLDEN32 = 0x9E3779B9
_GOLDEN64 = 0x9E3779B97F4A7C15 - (1 << 64)  # as an int64 bit pattern


@dataclasses.dataclass
class ShardedTable:
    """This rank's result rows: ``columns`` (local tensors) whose first
    ``num_rows`` rows are valid."""

    columns: dict
    num_rows: int
    mesh: object

    def to_numpy(self) -> dict:
        """Every rank's valid rows in rank order (a collective: every rank
        calls it and gets the whole result)."""
        return gather_rows(self.columns, self.num_rows, self.mesh)


def _gather_planes(planes, rows: int, mesh, counts=None):
    """Every rank's first ``rows`` rows of its int32 or int64 planes, in
    rank order, as planes: one all_gather of an int32 block of
    (words a row, longest) in which plane i takes its words' rows as its
    int32 view, after one all_gather of the row counts and a host read
    when ``counts`` (every rank's ``rows``) is not given."""
    dev = mesh.device
    if counts is None:
        counts = exchange.read_host(mesh_lib.all_gather(torch.tensor(
            [rows], dtype=torch.int64, device=dev), mesh)[:, 0])
    top = max(counts)
    block = torch.zeros((exchange.words_per_row(planes), top),
                        dtype=torch.int32, device=dev)
    slots, row = [], 0  # (first word, words a row, dtype) of each plane
    for p in planes:
        w = p.element_size() // 4
        block[row:row + w].view(-1)[:rows * w] = p[:rows].view(torch.int32)
        slots.append((row * top, w, p.dtype))
        row += w
    allb = mesh_lib.all_gather(block, mesh).view(len(counts), -1)
    return tuple(torch.cat([allb[r, at:at + c * w]
                            for r, c in enumerate(counts)]).view(dtype)
                 for at, w, dtype in slots)


def gather_rows(columns: Mapping, num_rows: int, mesh) -> dict:
    """numpy columns of the first ``num_rows`` rows of every rank, in rank
    order (every rank calls it and gets them all)."""
    names = sorted(columns)
    planes, specs = stream.payloads_to_planes(
        tuple(columns[n][:num_rows] for n in names))
    cols = stream.planes_to_payloads(
        _gather_planes(planes, num_rows, mesh), specs)
    return {n: dtypes.tensor_to_numpy(c) for n, c in zip(names, cols)}


def shard_table(table: Table, mesh) -> Table:
    """This rank's rows of a global table (every rank passes the same one):
    rows [r * per, (r + 1) * per), per = ceil(capacity / D), valid where
    the global row is below ``num_rows``."""
    cols = {k: mesh_lib.shard_1d(v, mesh) for k, v in table.columns.items()}
    per = -(-table.capacity // mesh.size)
    rows = torch.clamp(table.num_rows.to(mesh.device) - mesh.rank * per,
                       0, next(iter(cols.values())).shape[0])
    return Table(cols, num_rows=rows)


def _hash_dest_sub(keys: torch.Tensor, num_devices: int, num_sub: int = 1):
    """Multiplicative (Fibonacci) hash of the sortable key → (destination
    rank, sub-chunk), both int32: the rank from the hash's top 16 bits,
    the sub-chunk from the next 16.  Equal keys get equal pairs.

    The JAX uint32 product is taken exactly in int64: the key times each
    16-bit half of the constant stays below 2^48, and only the low 32 bits
    of the sum are kept.  The uint64 product wraps modulo 2^64 in int64
    as it does in uint64.
    ``>>`` on torch ints is arithmetic, so every field is masked after its
    shift.  1- and 2-byte keys come widened from ``to_sortable``, as the
    JAX package widens them before the product."""
    u = dtypes.to_sortable(keys)
    if u.element_size() == 8:
        h = u * _GOLDEN64
        top = (h >> 48) & 0xFFFF
        nxt = (h >> 32) & 0xFFFF
    else:
        u = u.to(torch.int64) & 0xFFFFFFFF
        h = (u * (_GOLDEN32 & 0xFFFF)
             + (((u * (_GOLDEN32 >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF
        top = h >> 16
        nxt = h & 0xFFFF
    dest = (top % num_devices).to(torch.int32)
    if num_sub == 1:
        return dest, torch.zeros_like(dest)
    return dest, (nxt % num_sub).to(torch.int32)


def _shuffle_table_chunks(table: Table, key: str, mesh,
                          overlap_chunks: int = 1):
    """Hash-shuffle this rank's valid rows in ``overlap_chunks`` sub-chunks.
    Returns (overflow, chunks); ``chunks`` yields (columns, rows) of the
    rows this rank received in each sub-chunk, source-major.  Padding rows
    go to the bucket past the last (sub-chunk, rank) pair, never sent; one
    stable partition by (sub-chunk, rank) feeds every exchange."""
    D, G = mesh.size, max(1, overlap_chunks)
    names = table.column_names
    dest, sub = _hash_dest_sub(table[key], D, G)
    bucket = torch.where(table.valid_mask(), sub * D + dest, G * D)
    planes, specs = stream.payloads_to_planes(
        tuple(table[n] for n in names))
    parted, counts, starts = exchange.partition_by_bucket(bucket, planes,
                                                          G * D + 1)
    overflow, chunks = exchange.all_to_all_chunks(parted, counts, starts,
                                                  mesh, G)

    def tables():
        for _, got, _ in chunks:
            cols = stream.planes_to_payloads(got, specs)
            yield dict(zip(names, cols)), got[0].shape[0]

    return overflow, tables()


def _chunk_table(cols: dict, rows: int) -> Table:
    """The rows received in a sub-chunk as a Table.  An empty sub-chunk
    keeps one padding row, so the operator's outputs keep their dtypes."""
    if rows == 0:
        cols = {k: dtypes.from_container(torch.cat(
            [dtypes.as_container(v), dtypes.as_container(v).new_zeros(1)]),
            v.dtype) for k, v in cols.items()}
    return Table(cols, num_rows=rows)


def _stitch(parts, names, mesh) -> ShardedTable:
    """The valid prefix of each part's columns, in part order (one host
    read of the parts' row counts)."""
    rows = exchange.read_host(torch.stack([p.num_rows for p in parts]))
    cols = {n: torch.cat([p.columns[n][:r] for p, r in zip(parts, rows)])
            for n in names}
    return ShardedTable(cols, sum(rows), mesh)


def dist_hash_aggregate(table: Table, key: str, aggs: Mapping, mesh=None,
                        capacity_factor: float = 2.5,
                        config: SortConfig = DEFAULT_CONFIG,
                        overlap_chunks: int = 2):
    """GROUP BY over rows sharded across the mesh (``table`` is this
    rank's).  Returns (ShardedTable, overflow): each rank holds the groups
    of the keys hashed to it, sub-chunk by sub-chunk, each in ascending key
    order.  ``overflow`` is always False (the exchange is exact);
    ``capacity_factor`` is accepted for the JAX signature and unused."""
    del capacity_factor
    if mesh is None:
        mesh = mesh_lib.make_mesh(device=table.device)
    _, chunks = _shuffle_table_chunks(table, key, mesh, overlap_chunks)
    parts = [agg_ops.hash_aggregate(_chunk_table(cols, rows), key, aggs,
                                    config=config, method="scan")
             for cols, rows in chunks]
    return _stitch(parts, sorted({key, *aggs}), mesh), False


def dist_top_k(table: Table, key: str, k: int, *, largest: bool = True,
               mesh=None, config: SortConfig = DEFAULT_CONFIG) -> Table:
    """Global ORDER BY key (DESC if largest) LIMIT k over rows sharded
    across the mesh; every rank gets the same Table of capacity k.

    No shuffle: each rank selects its local top min(k, capacity)
    (ops/topk.py), one all_gather brings every rank's candidates to every
    rank, and the final selection runs on each.  Tie order: rank, then
    local rank (global first-occurrence order is NOT kept across ranks), as
    in the JAX package.  ``k`` may not exceed the capacity of all ranks'
    tables together."""
    if mesh is None:
        mesh = mesh_lib.make_mesh(device=table.device)
    D = mesh.size
    cap = table.capacity
    names = table.column_names
    dev = mesh.device
    cand = topk_ops.topk_table(table, key, min(k, cap), largest=largest,
                               config=config)
    info = exchange.read_host(mesh_lib.all_gather(torch.stack([
        cand.num_rows.to(torch.int64),
        torch.tensor(cap, dtype=torch.int64, device=dev)]), mesh))
    if k > sum(c for _, c in info):
        raise ValueError(f"k={k} exceeds table capacity "
                         f"{sum(c for _, c in info)}")
    kl = min(k, max(c for _, c in info))  # candidate slots a rank
    planes, specs = stream.payloads_to_planes(
        tuple(cand.columns[n] for n in names))
    cols = dict(zip(names, stream.planes_to_payloads(_gather_planes(
        planes, cand.capacity, mesh, [kl] * D), specs)))
    rows = torch.tensor([r for r, _ in info], device=dev)
    valid = (torch.arange(kl, device=dev)[None, :] < rows[:, None]).reshape(-1)
    # valid candidates first (rank order kept), then a stable sort of the
    # complemented score: best first, ties in (rank, local rank) order,
    # the empty slots (max score) after every real row
    packed, n_valid = partition.compact_mask(
        valid, tuple(cols[n] for n in names), method="stream", config=config)
    cols = dict(zip(names, packed))
    bits = dtypes.key_bits(cols[key].dtype)
    score = dtypes.to_sortable(cols[key])
    inv = dtypes.complement(score, bits) if largest else score
    slot = torch.arange(D * kl, device=dev)
    inv = torch.where(slot < n_valid, inv,
                      dtypes.complement(torch.zeros_like(inv), bits))
    _, out = sort_ops.sort_biased_kv(inv, tuple(cols[n] for n in names),
                                     config, bits)
    total = min(sum(r for r, _ in info), k)
    return Table({n: c[:k] for n, c in zip(names, out)}, num_rows=total)


def dist_hash_join(probe: Table, build: Table, key: str, mesh=None,
                   capacity_factor: float = 2.5, max_duplicates: int = 1,
                   suffixes=("", "_r"), config: SortConfig = DEFAULT_CONFIG,
                   overlap_chunks: int = 2):
    """Inner join of rows sharded across the mesh (``probe`` and ``build``
    are this rank's).  Both sides shuffle by the same hash into the same
    sub-chunks, so equal keys meet on one rank in one sub-chunk; sub-chunk
    g + 1 of both sides is on the wire while g joins.

    Returns (ShardedTable, stats): ``match_count`` (int32) and
    ``overflow`` (a key's build rows past ``max_duplicates``), summed over
    the mesh by one all_reduce, as 0-d tensors on the mesh's device.  The
    shuffle cannot overflow; ``capacity_factor`` is unused."""
    del capacity_factor
    if mesh is None:
        mesh = mesh_lib.make_mesh(device=probe.device)
    out_names = [n + suffixes[0] for n in probe.column_names]
    for n in build.column_names:
        out_names.append(n + suffixes[1] if (n + suffixes[0]) in out_names
                         else n)
    _, p_chunks = _shuffle_table_chunks(probe, key, mesh, overlap_chunks)
    _, b_chunks = _shuffle_table_chunks(build, key, mesh, overlap_chunks)
    parts = []
    matches = torch.zeros((), dtype=torch.int64, device=mesh.device)
    over = torch.zeros((), dtype=torch.int64, device=mesh.device)
    for (pc, pr), (bc, br) in zip(p_chunks, b_chunks):
        out, stats = join_ops.hash_join(
            _chunk_table(pc, pr), _chunk_table(bc, br), key,
            max_duplicates=max_duplicates, suffixes=suffixes, config=config)
        parts.append(out)
        matches = matches + stats["match_count"]
        over = over + stats["overflow"].to(torch.int64)
    tot = mesh_lib.all_reduce_sum(torch.stack([matches, over]), mesh)
    stats = {"match_count": tot[0].to(torch.int32), "overflow": tot[1] > 0}
    return _stitch(parts, out_names, mesh), stats
