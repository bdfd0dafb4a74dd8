"""Ragged all-to-all: the distributed radix shuffle's transport.

Port of ``radix_sort_tpu/parallel/exchange.py``, by its contract and not
its fixed-capacity slots, which exist because XLA needs static shapes:

- rows labelled with a destination rank arrive there source-major, rows of
  source s in s's order (the partition before the exchange is stable), so a
  stable sort after it is stable over the whole mesh;
- ``recv_counts`` is the (D,) int32 row count from each source;
- ``overflow`` says that some (source, destination) pair exceeded the
  ``capacity`` the caller passed, and every rank agrees on it; with no
  capacity it is False.  The exchange itself is exact: every row arrives,
  over capacity or not.

One exchange is three steps: one ``all_to_all_single`` of the counts (and
each rank's overflow flag), ONE host read of the split sizes, and ONE
``all_to_all_single`` of every plane packed as one contiguous int32 block:
destination by destination, each destination's rows plane by plane
(:func:`pack_runs`).  The planes are those of ``stream.payloads_to_planes``,
int32 or int64, and each rides the block as its int32 view: an int64 plane
is 2 words a row, and a destination's run is ``count * words`` long, where
``words`` is the planes' words a row.  Every piece of the block is a
contiguous copy, and the planes received from one source are contiguous
slices of the block (an int64 one copied where it starts at an odd word);
an interleaved (rows, planes) block took 3.2 ms to pack and 1.1 ms to
unpack for 2^27 rows of two planes on an H100 80GB HBM3 at 700 W, against
the 1.3 ms of the radix pass that moves the same rows
(scripts/dist_profile.py).
:func:`all_to_all_chunks` runs the exchanges of G sub-chunks
with one count exchange and one host read for all of them, and sends
sub-chunk g + 1 (``async_op``) before it hands over sub-chunk g, so the
caller's local work on g overlaps g + 1's transfer.

The partition before an exchange is ``partition_planes``, the radix
kernels' stable pass (ops/stream.py): every bucket id the distributed layer
makes lies in [0, buckets) by construction, as that pass requires.
"""

from __future__ import annotations

import torch

from ..ops import stream
from . import mesh as mesh_lib

# Host reads of the layer (split sizes, row counts that size an output),
# counted as stream.host_reads counts chunked_sort's.
host_reads = 0


def read_host(t: torch.Tensor) -> list:
    """``t.tolist()``, counted in :data:`host_reads`."""
    global host_reads
    host_reads += 1
    return t.tolist()


def partition_by_bucket(bucket: torch.Tensor, planes, num_buckets: int):
    """Stable partition of int32 or int64 ``planes`` by ``bucket`` (ids in
    [0, num_buckets)) with the radix kernels' pass.  Returns (planes,
    counts, starts), counts and starts (num_buckets,) int32."""
    parted, counts = stream.partition_planes(bucket, tuple(planes),
                                             num_buckets)
    counts = counts.to(torch.int32)
    return parted, counts, torch.cumsum(counts, 0, dtype=torch.int32) - counts


def words_per_row(planes) -> int:
    """The int32 words a row of ``planes`` (int32 or int64) takes in a
    packed block."""
    return sum(p.element_size() // 4 for p in planes)


def _as_plane(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A slice of int32 words as a plane of ``dtype`` (int32 or int64).
    An int64 view needs an even word offset: a slice at an odd one is
    copied first."""
    if dtype == torch.int32:
        return words
    if words.storage_offset() % 2:
        words = words.clone()
    return words.view(dtype)


def pack_runs(planes, runs) -> torch.Tensor:
    """One contiguous int32 block of the rows of each run (first, count)
    of the planes (int32 or int64, each as its int32 view): run 0's rows of
    plane 0, of plane 1, ..., then run 1's.  The block for rank d is run d,
    ``count * words_per_row(planes)`` elements."""
    parts = [p[first:first + count].view(torch.int32)
             for first, count in runs for p in planes]
    return torch.cat(parts)


def unpack_runs(block: torch.Tensor, counts, plane_dtypes):
    """Inverse of :func:`pack_runs`: the planes, of ``plane_dtypes``, of
    the rows of every run (``counts`` rows each), runs in order.  One run's
    planes are views of the block (an int64 plane at an odd word offset a
    copy); several runs are concatenated."""
    runs, off = [], 0
    for c in counts:
        run = []
        for d in plane_dtypes:
            w = c * d.itemsize // 4
            run.append(block[off:off + w])
            off += w
        runs.append(run)
    if len(runs) == 1:
        return tuple(_as_plane(p, d) for p, d in zip(runs[0], plane_dtypes))
    return tuple(_as_plane(torch.cat([r[i] for r in runs]), d)
                 for i, d in enumerate(plane_dtypes))


def _exchange_counts(counts: torch.Tensor, starts: torch.Tensor, mesh,
                     capacity):
    """counts, starts: (G, D) — rows of sub-chunk g for rank d and where
    they begin.  One all_to_all of each rank's counts and overflow flag,
    then one host read of what this rank sends and receives.  Returns
    (send[g][d], recv[g][s], starts[g][d] as host lists, recv counts (G, D)
    on the device, overflow)."""
    G, D = counts.shape
    counts = counts.to(torch.int64)
    flag = (counts > capacity).any() if capacity is not None else (
        torch.zeros((), dtype=torch.bool, device=counts.device))
    block = torch.cat([counts.T, flag.to(torch.int64).expand(D, 1)],
                      dim=1).contiguous()                   # (D, G + 1)
    got = torch.empty_like(block)
    mesh_lib.all_to_all_rows(got, block, [1] * D, [1] * D, mesh)
    # row d: G counts sent to d, G counts and the flag from d, G starts
    host = read_host(torch.cat([block[:, :G], got,
                                starts.T.to(torch.int64)], dim=1))
    send = [[host[d][g] for d in range(D)] for g in range(G)]
    recv = [[host[s][G + g] for s in range(D)] for g in range(G)]
    first = [[host[d][2 * G + 1 + g] for d in range(D)] for g in range(G)]
    # every rank received every rank's flag, so all agree on the OR
    overflow = any(host[s][2 * G] for s in range(D))
    return send, recv, first, got[:, :G].T.to(torch.int32), overflow


def send_runs(planes, runs, recv, mesh, async_op: bool = False):
    """Send run d of the planes (first, count) to rank d and receive
    ``recv[s]`` rows from each rank s: one all_to_all_single of the packed
    int32 block.  Returns (work or None, received block, the block sent,
    which lives until the work is done)."""
    W = words_per_row(planes)
    block = pack_runs(planes, runs)
    out = torch.empty(sum(recv) * W, dtype=torch.int32, device=block.device)
    work = mesh_lib.all_to_all_rows(out, block, [c * W for c in recv],
                                    [c * W for _, c in runs], mesh,
                                    async_op=async_op)
    return work, out, block


def all_to_all_chunks(planes, counts: torch.Tensor, starts: torch.Tensor,
                      mesh, num_chunks: int = 1, capacity: int | None = None):
    """Exchange G = ``num_chunks`` sub-chunks of partitioned int32 or
    int64 planes: rows of sub-chunk g for rank d sit at
    ``starts[g * D + d]``, ``counts[g * D + d]`` long.

    Returns (overflow, chunks): ``chunks`` yields (g, planes received,
    recv_counts (D,) int32) in g order, each sub-chunk's rows source-major.
    It starts sub-chunk g + 1's exchange before it yields sub-chunk g."""
    D, G = mesh.size, num_chunks
    planes = tuple(planes)
    plane_dtypes = tuple(p.dtype for p in planes)
    send, recv, first, rcounts, overflow = _exchange_counts(
        counts[:G * D].reshape(G, D), starts[:G * D].reshape(G, D), mesh,
        capacity)

    def issue(g):
        return send_runs(planes, list(zip(first[g], send[g])), recv[g],
                         mesh, async_op=G > 1)

    def chunks():
        pending = issue(0)
        for g in range(G):
            nxt = issue(g + 1) if g + 1 < G else None
            work, out, _ = pending
            if work is not None:
                work.wait()
            yield g, unpack_runs(out, recv[g], plane_dtypes), rcounts[g]
            pending = nxt

    return overflow, chunks()


def _exchange_once(planes, specs, counts, starts, mesh, capacity):
    overflow, chunks = all_to_all_chunks(planes, counts, starts, mesh, 1,
                                         capacity)
    _, got, rcounts = next(chunks)
    return stream.planes_to_payloads(got, specs), rcounts, overflow


def packed_all_to_all(parted, counts: torch.Tensor, starts: torch.Tensor,
                      mesh, capacity: int | None = None):
    """Exchange ALREADY-partitioned rows: rank d's rows sit at
    ``parted[i][starts[d] : starts[d] + counts[d]]`` (any stable partition
    with contiguous runs, possibly a slice of a larger multi-bucket one).

    Returns (recv_arrays, recv_counts, overflow): the rows received,
    source-major, in each array's dtype; (D,) int32 counts by source; and
    whether some pair exceeded ``capacity``."""
    planes, specs = stream.payloads_to_planes(tuple(parted))
    return _exchange_once(planes, specs, counts, starts, mesh, capacity)


def ragged_all_to_all(arrays, dest: torch.Tensor, mesh,
                      drop_mask: torch.Tensor | None = None,
                      capacity: int | None = None):
    """Exchange rows of ``arrays`` (1-D tensors of this rank) to the ranks
    ``dest`` (int in [0, D)) names; rows with ``drop_mask`` set are not
    sent.  Same return as :func:`packed_all_to_all`."""
    D = mesh.size
    nb = D
    if drop_mask is not None:
        dest = torch.where(drop_mask, D, dest)
        nb = D + 1  # a bucket past the last rank, never sent
    planes, specs = stream.payloads_to_planes(tuple(arrays))
    parted, counts, starts = partition_by_bucket(dest, planes, nb)
    return _exchange_once(parted, specs, counts, starts, mesh, capacity)


def slot_valid_mask(num_devices: int, capacity: int,
                    recv_counts: torch.Tensor) -> torch.Tensor:
    """(D * capacity,) bool mask of the rows a fixed-capacity exchange
    would hold, slot s's first recv_counts[s]: the JAX slot layout, for
    callers that pass a capacity."""
    j = torch.arange(capacity, dtype=torch.int32, device=recv_counts.device)
    return (j[None, :] < recv_counts[:, None]).reshape(-1)
