"""Multi-plane stable reorder: the radix sort and the one-pass partition.

Port of ``radix_sort_tpu/ops/pallas_stream.py``.  Keys and payloads travel
as int32 word planes: a 4-byte column is one plane, an 8-byte column a
(lo, hi) pair (``x.view(torch.int32).reshape(n, 2)``), a narrower column is
widened to one plane.  So every kernel sees only int32 planes.  A sort is
one ``pass_histograms`` launch over the key word planes, one host read of
its (P, R) table, and one ``onesweep_pass`` launch for each pass that one
digit does not fill, moving every plane by the digit of one of them.

What the TPU engine needed and the port does not: the 128-lane row layout,
padding to whole tiles (the kernels mask the ragged tile), the
heads/tails carries and the ``_boundary_fixup`` epilogue (each CTA writes
every element it owns), and the SMEM table caps of ``_round_rows``.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG
from . import cuda_radix as cr

_TILE = DEFAULT_CONFIG.tile_elems
_THREADS = DEFAULT_CONFIG.threads_per_cta


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


# Host reads of pass histograms; a sort or a partition makes one.
host_reads = 0


def _read_full_passes(hist: torch.Tensor, n: int) -> list:
    """Which rows of a (P, R) pass histogram one digit fills: the one read
    of the card a sort makes."""
    global host_reads
    host_reads += 1
    return (hist == n).any(dim=1).tolist()


def _sort_planes(planes, passes, radix: int, tile: int,
                 threads: int = _THREADS):
    """Onesweep LSD loop: plane w (w < len(passes)) carries passes[w]
    digits, pass j's at shift j * log2(radix); every plane moves every
    pass.  One pass_histograms launch gives every pass's digit totals, the
    host reads them once, and each pass that no single digit fills is one
    onesweep_pass launch — a filled pass is the identity, the reference's
    CPU early-exit (CRadixSortCPU.h).  The passes ping-pong between two
    buffer sets allocated here, and their look-back scratch is zeroed by
    one memset.  Returns the planes after the last pass."""
    planes = tuple(planes)
    n = planes[0].numel()
    bits = radix.bit_length() - 1
    hist = cr.pass_histograms(planes[:len(passes)], passes, radix)
    full = _read_full_passes(hist, n)
    rows = [(w, j * bits) for w, np_ in enumerate(passes) for j in range(np_)]
    run = [(row, w, shift) for row, (w, shift) in enumerate(rows)
           if not full[row]]
    if not run:
        return planes
    on_card = planes[0].device.type == "cuda"
    scratch = (cr.onesweep_scratch(n, radix, tile, len(run), planes[0].device)
               if on_card else [None] * len(run))
    bufs = [tuple(torch.empty_like(p) for p in planes)
            for _ in range(min(2, len(run)))]
    for i, (row, w, shift) in enumerate(run):
        planes, _ = cr.onesweep_pass(planes[w], planes, hist[row], radix,
                                     tile, shift, scratch=scratch[i],
                                     outs=bufs[i % 2], threads=threads)
    return planes


def _key_word_planes(keys_bits: torch.Tensor):
    """Split sortable key bits (int32 or int64 container) into contiguous
    int32 word planes in LSD order: one for 32-bit keys, (lo, hi) for
    64-bit keys."""
    if keys_bits.element_size() == 4:
        return (keys_bits.contiguous(),)
    words = keys_bits.contiguous().view(torch.int32).view(-1, 2)
    return (words[:, 0].contiguous(), words[:, 1].contiguous())


def _join_key_word_planes(word_planes, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`_key_word_planes` into the ``dtype`` container."""
    if len(word_planes) == 1:
        return word_planes[0]
    return torch.stack(tuple(word_planes), dim=1).view(dtype).view(-1)


def sort_planes(keys_bits: torch.Tensor, payload_planes=(), radix: int = 256,
                tile: int = _TILE, threads: int = _THREADS,
                total_bits: int | None = None):
    """Stable LSD sort of sortable key bits plus any number of int32
    payload planes, all riding the same permutation every pass.

    ``total_bits`` caps the sorted key width when the caller knows every
    key is below 2**total_bits: fewer passes run, not just skipped.
    Returns (keys_bits_out, payload_planes_out)."""
    n = keys_bits.shape[0]
    payload_planes = tuple(payload_planes)
    if n == 0:
        return keys_bits, payload_planes
    kplanes = _key_word_planes(keys_bits)
    nk = len(kplanes)
    bits_per = radix.bit_length() - 1
    kbits = 8 * keys_bits.element_size() if total_bits is None else total_bits
    passes = tuple(-(-min(32, kbits - 32 * w) // bits_per) for w in range(nk)
                   if kbits > 32 * w)
    out = _sort_planes(kplanes + payload_planes, passes, radix, tile,
                       threads)
    return _join_key_word_planes(out[:nk], keys_bits.dtype), out[nk:]


def partition_planes(bucket_ids: torch.Tensor, planes_i32, num_buckets: int,
                     tile: int = _TILE, threads: int = _THREADS):
    """Stable partition of int32 planes by bucket id: rows of bucket 0
    first, each bucket in input order.

    ``bucket_ids`` must lie in [0, num_buckets) — a contract, not a checked
    precondition: the digit is ``ids & (radix - 1)``, so an id outside the
    range wraps into a low bucket (as in the JAX engine).  Up to 256
    buckets take one pass with the ids as the digit plane, not moved; more
    buckets take LSD passes of 8 bits over the ids, which then move too.
    Returns (partitioned planes, counts (num_buckets,) int32)."""
    ids = bucket_ids.to(torch.int32).contiguous()
    planes = tuple(planes_i32)
    n = ids.numel()
    if n == 0:
        return planes, torch.zeros(num_buckets, dtype=torch.int32,
                                   device=ids.device)
    radix = max(2, _next_pow2(num_buckets))
    if radix <= 256:
        hist = cr.pass_histograms((ids,), (1,), radix)
        totals = hist[0, :num_buckets]
        if _read_full_passes(hist, n)[0]:
            return planes, totals
        outs, _ = cr.onesweep_pass(ids, planes, hist[0], radix, tile, 0,
                                   threads=threads)
        return outs, totals
    bits = radix.bit_length() - 1
    out = _sort_planes((ids,) + planes, (-(-bits // 8),), 256, tile, threads)
    counts = torch.bincount(ids.to(torch.int64), minlength=num_buckets)
    return out[1:], counts[:num_buckets].to(torch.int32)


def payloads_to_planes(payloads):
    """Map 1-D payload tensors to int32 planes: 4-byte dtypes view as one
    plane, 8-byte dtypes split into (lo, hi) word planes, narrower dtypes
    widen to one plane.  Returns (planes, specs) for
    :func:`planes_to_payloads`."""
    planes, specs = [], []
    for p in payloads:
        c = dtypes.as_container(p).contiguous()
        if c.dtype.itemsize == 4:
            planes.append(c.view(torch.int32))
        elif c.dtype.itemsize == 8:
            planes += list(_key_word_planes(c.view(torch.int64)))
        else:
            planes.append(c.to(torch.int32))
        specs.append((p.dtype, c.dtype))
    return tuple(planes), tuple(specs)


def planes_to_payloads(planes, specs):
    """Inverse of :func:`payloads_to_planes`."""
    out, i = [], 0
    for dtype, container in specs:
        if container.itemsize == 4:
            c = planes[i].view(container)
            i += 1
        elif container.itemsize == 8:
            c = _join_key_word_planes(planes[i:i + 2], torch.int64).view(
                container)
            i += 2
        else:
            c = planes[i].to(container)
            i += 1
        out.append(dtypes.from_container(c, dtype))
    return tuple(out)
