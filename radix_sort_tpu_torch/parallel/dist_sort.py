"""Distributed sort over a mesh of ranks: the multi-card radix shuffle.

Port of ``radix_sort_tpu/parallel/dist_sort.py``.  Keys laid out as
``mesh.shard_1d`` lays them out (rank r holds global rows [r * per,
(r + 1) * per), per = ceil(n / D)) are sorted globally, stably, with every
payload riding along:

  1. sample     — every rank contributes strided samples of its (padded)
                  keys; an all_gather and a replicated radix sort pick
                  D*G - 1 splitters.
  2. assign     — each key's interval is its splitter interval; keys EQUAL
                  to a splitter spread over the tied range by their global
                  rank among equals (a stable partition by tie group, an
                  all_gather of the group counts), so Zeros balances.
  3. shuffle    — the exact ragged exchange (exchange.py): one stable
                  partition by (sub-chunk, rank), counts, one host read,
                  then one all_to_all of the packed planes per sub-chunk.
  4. local sort — a stable radix sort of the rows received (source-major,
                  so the order over the mesh stays stable); with G > 1
                  sub-chunk g sorts while g + 1 is on the wire, and the
                  sorted sub-chunks concatenate (ascending value ranges).
  5. rebalance  — one all_gather of the row counts and one all_to_all put
                  exactly ``per`` sorted rows on each rank; the padding
                  rows (the max sentinel, global rows [n, D * per)) fall
                  at the end and are cut.

With an exact exchange every received row is valid, so the JAX package's
valid-first sort (``_local_sorted_valid_first``) is one ``sort_biased_kv``
and its capacity escalation has nothing to retry.
"""

from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..ops import sort as sort_ops, stream
from . import exchange, mesh as mesh_lib


def _strided_samples(x: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` samples of ``x`` (n >= 1) at stride n // count, the last
    repeated when x is short."""
    n = x.shape[0]
    stride = max(1, n // count)
    s = x[::stride][:count]
    if s.shape[0] < count:
        s = torch.cat([s, s[-1:].expand(count - s.shape[0])])
    return s


def _choose_splitters(all_samples: torch.Tensor, num_intervals: int,
                      config: SortConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """num_intervals - 1 evenly spaced order statistics (unsigned order)
    of the gathered sortable samples."""
    s, _ = sort_ops.sort_biased_kv(all_samples, (), config)
    m = s.shape[0]
    idx = (torch.arange(1, num_intervals, device=s.device) * m
           ) // num_intervals
    return s[idx]


def _assign_destinations(chunk_u: torch.Tensor, splitters: torch.Tensor,
                         num_intervals: int, mesh) -> torch.Tensor:
    """Interval per key (int32), ties spread by global rank among equals.

    ``splitters`` are sortable bits in ascending unsigned order (as
    :func:`_choose_splitters` gives them).  lo = #splitters < key and hi =
    #splitters <= key by binary search on the signed image (the unsigned
    order of the containers); untied keys go to lo.  A tied key's rank
    among equals on this rank comes from one stable partition by tie group
    (the radix kernels' pass), the ranks before it from one all_gather of
    the group counts; it lands at lo_s + grank // ceil(total / (width+1)),
    the JAX capacity form, computed in int64 (the same values wherever the
    JAX int32 arithmetic does not wrap)."""
    D = num_intervals
    n = chunk_u.shape[0]
    dev = chunk_u.device
    if D == 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    S = D - 1
    spl = dtypes.signed_order(splitters).contiguous()
    key = dtypes.signed_order(chunk_u).contiguous()
    lo = torch.searchsorted(spl, key)
    hi = torch.searchsorted(spl, key, right=True)
    tied = lo != hi
    # group = the first splitter equal to the key; untied keys: group S
    j = torch.where(tied, lo.clamp(max=S - 1), S).to(torch.int32)

    iota = torch.arange(n, dtype=torch.int32, device=dev)
    (order, js), counts, starts = exchange.partition_by_bucket(
        j, (iota, j), S + 1)
    js = js.to(torch.int64)
    rank_sorted = torch.arange(n, device=dev) - starts.to(torch.int64)[js]

    counts_mat = mesh_lib.all_gather(counts[:S].to(torch.int64), mesh)
    prev = counts_mat[:mesh.rank].sum(0)
    total = counts_mat.sum(0).clamp_min(1)
    lo_s = torch.searchsorted(spl, spl)
    width = torch.searchsorted(spl, spl, right=True) - lo_s
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    prev, total = torch.cat([prev, zero]), torch.cat([total, zero])
    lo_s, width = torch.cat([lo_s, zero]), torch.cat([width, zero])

    grank = prev[js] + rank_sorted
    w1 = width[js] + 1
    cap = ((total[js] + w1 - 1) // w1).clamp_min(1)
    spread_sorted = lo_s[js] + grank // cap
    spread = torch.empty_like(spread_sorted)
    spread[order.to(torch.int64)] = spread_sorted  # back to input order
    dest = torch.where(tied, spread, lo)
    return dest.clamp(0, D - 1).to(torch.int32)


def _sorted_chunk(planes, nk: int, key_dtype, total_bits, config):
    """Stable sort of received planes by their key word planes (the first
    ``nk``); returns the planes sorted."""
    keys = stream.join_key_word_planes(planes[:nk], key_dtype)
    ks, ps = sort_ops.sort_biased_kv(keys, planes[nk:], config, total_bits)
    return stream.key_word_planes(ks) + tuple(ps)


def _rebalance(planes, per: int, mesh):
    """Rows of planes sorted across the mesh in rank order →
    exactly ``per`` rows a rank (global rows [r * per, (r + 1) * per)).
    One all_gather of the row counts, one host read, one all_to_all: the
    rows for rank d are a contiguous run, so no partition is needed."""
    D, me = mesh.size, mesh.rank
    rows = torch.tensor([planes[0].shape[0]], dtype=torch.int64,
                        device=planes[0].device)
    counts = exchange.read_host(mesh_lib.all_gather(rows, mesh)[:, 0])
    g0 = [sum(counts[:s]) for s in range(D)]
    lo = [min(max(d * per - g0[me], 0), counts[me]) for d in range(D + 1)]
    recv = [max(0, min((me + 1) * per, g0[s] + counts[s])
                - max(me * per, g0[s])) for s in range(D)]
    runs = [(lo[d], lo[d + 1] - lo[d]) for d in range(D)]
    _, out, _ = exchange.send_runs(planes, runs, recv, mesh)
    return exchange.unpack_runs(out, recv, tuple(p.dtype for p in planes))


def _dist_sort_shard(ku, planes_pay, *, mesh, samples, G, config,
                     total_bits, per):
    """One rank's part of the sort: ``ku`` sortable bits of its padded
    shard (``per`` rows), ``planes_pay`` its payload planes.  Returns
    the planes (key word planes first) of global sorted rows
    [r * per, (r + 1) * per)."""
    D = mesh.size
    smp = _strided_samples(ku, samples)
    all_smp = mesh_lib.all_gather(smp, mesh).reshape(-1)
    splitters = _choose_splitters(all_smp, D * G, config)
    sidx = _assign_destinations(ku, splitters, D * G, mesh)
    # interval s goes to rank s // G as sub-chunk s % G: one partition by
    # (sub-chunk, rank) feeds every exchange
    bucket = sidx if G == 1 else (sidx % G) * D + sidx // G
    kplanes = stream.key_word_planes(ku)
    nk = len(kplanes)
    parted, counts, starts = exchange.partition_by_bucket(
        bucket, kplanes + tuple(planes_pay), D * G)
    _, chunks = exchange.all_to_all_chunks(parted, counts, starts, mesh, G)
    parts = [_sorted_chunk(got, nk, ku.dtype, total_bits, config)
             for _, got, _ in chunks]
    if G > 1:  # ascending value ranges: the sorted run is their concat
        parts = [tuple(torch.cat(col) for col in zip(*parts))]
    return _rebalance(parts[0], per, mesh)


def dist_sort_kv(local_keys: torch.Tensor, local_values=None, mesh=None,
                 capacity_factor: float = 2.5, samples_per_device: int = 64,
                 config: SortConfig = DEFAULT_CONFIG,
                 overlap_chunks: int = 2):
    """Globally sort keys sharded over the mesh (and permute
    ``local_values``, a pytree of this rank's payload tensors, alongside).

    Every rank passes its shard as ``mesh.shard_1d`` makes it; every rank
    gets back its shard of the sorted result in the same layout (the JAX
    output layout: rank r holds sorted rows [r * per, (r+1) * per) of
    [0, n), per = ceil(n / D)).  Returns (keys, values, overflow).

    ``overflow`` is always False: the exchange sends exactly the rows
    there are, so no slot can overflow and nothing is retried.
    ``capacity_factor`` is accepted for the JAX signature and unused.
    ``overlap_chunks`` G > 1 cuts the key space into D*G intervals and
    exchanges them in G sub-chunks, each sent while the one before it
    sorts (G = 1 when D = 1).  Host reads (``exchange.host_reads``): the
    global row count, one for the exchange's split sizes, one for the
    rebalance; the sorts read nothing."""
    del capacity_factor  # no fixed-capacity slots
    if mesh is None:
        mesh = mesh_lib.make_mesh(device=local_keys.device)
    D = mesh.size
    m = local_keys.shape[0]
    sizes = exchange.read_host(mesh_lib.all_gather(torch.tensor(
        [m], dtype=torch.int64, device=mesh.device), mesh)[:, 0])
    n = sum(sizes)
    per = -(-max(n, D) // D)
    want = [min(per, max(0, n - r * per)) for r in range(D)]
    if sizes != want:
        raise ValueError(f"keys of the {D} ranks have lengths {sizes}; "
                         f"dist_sort_kv takes the layout of shard_1d "
                         f"({want})")
    G = max(1, overlap_chunks) if D > 1 else 1
    samples = min(samples_per_device * G, per)

    ku = dtypes.to_sortable(local_keys)
    leaves, spec = (pytree.tree_flatten(local_values)
                    if local_values is not None else ([], None))
    planes_pay, specs = stream.payloads_to_planes(tuple(leaves))
    if per > m:  # the max sentinel pads the shard, as in the JAX layout
        ku = torch.cat([ku, ku.new_full((per - m,), dtypes.SENTINEL_BITS)])
        planes_pay = tuple(torch.cat([p, p.new_zeros(per - m)])
                           for p in planes_pay)
    nk = 1 if ku.element_size() == 4 else 2
    planes = _dist_sort_shard(ku, planes_pay, mesh=mesh, samples=samples,
                              G=G, config=config,
                              total_bits=dtypes.key_bits(local_keys.dtype),
                              per=per)
    mine = want[mesh.rank]  # the padding rows sort last, past row n
    planes = tuple(p[:mine] for p in planes)
    ks = dtypes.from_sortable(
        stream.join_key_word_planes(planes[:nk], ku.dtype),
        local_keys.dtype)
    vals = stream.planes_to_payloads(planes[nk:], specs)
    values_out = (pytree.tree_unflatten(list(vals), spec)
                  if spec is not None else None)
    return ks, values_out, False


def dist_sort(local_keys: torch.Tensor, **kwargs) -> torch.Tensor:
    """Key-only :func:`dist_sort_kv`."""
    ks, _, _ = dist_sort_kv(local_keys, None, **kwargs)
    return ks
