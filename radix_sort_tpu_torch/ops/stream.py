"""The plane format and the multi-plane stable reorder: the radix sort and
the one-pass partition.

Port of ``radix_sort_tpu/ops/pallas_stream.py``.  This module is the one
owner of how a column rides the radix pass; the kernels (ops/cuda_radix.py)
take planes and know nothing of columns.

- A key travels as int32 word planes (:func:`key_word_planes`): a 4-byte
  key is one plane, an 8-byte key a (lo, hi) pair
  (``x.view(torch.int32).reshape(n, 2)``).  A 1- or 2-byte key of the sort
  entry points is the exception: it stays the caller's bits at its own
  width, and the kernels take its digits from its sortable image
  (:func:`sort_narrow`).
- A payload column travels at its own width where it is 4 or 8 bytes, as
  a view of its bits (int32, or int64 that the pass kernel moves 8 bytes
  at a time), and a narrower one is widened to one int32 plane
  (:func:`payloads_to_planes`).  The distributed layer's exchange moves
  these planes as they are.

A sort is one ``pass_histograms`` launch over the key planes and one
``onesweep_pass`` launch for every pass, moving every plane by the digit
of one of them, all enqueued on a card by one call into the kernel
library (``cuda_radix.sort_passes``).  Each launch decides on the card,
from the (P, R) table, whether one digit fills its pass (then it is the
identity and returns) and which buffer set it reads and writes, as the
JAX engine decides with
``lax.cond`` (``pallas_stream.py:572``): the host reads nothing back, and
the result is always new storage, never the caller's tensors.

What the TPU engine needed and the port does not: the 128-lane row layout,
padding to whole tiles (the kernels mask the ragged tile), the
heads/tails carries and the ``_boundary_fixup`` epilogue (each CTA writes
every element it owns), and the SMEM table caps of ``_round_rows``.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..utils import profiling
from . import cuda_radix as cr

_TILE = DEFAULT_CONFIG.tile_elems
_THREADS = DEFAULT_CONFIG.threads_per_cta


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


# Host reads of the card by the sort path: chunked_sort's chunk sizes.  A
# sort, a partition and the operators on them make none.
host_reads = 0


def _empty_like_all(planes) -> tuple:
    return tuple(torch.empty_like(p) for p in planes)


def _sort_planes(planes, passes, radix: int, tile: int,
                 threads: int = _THREADS, kind: str = "u"):
    """Onesweep LSD sort: plane w (w < len(passes)) carries passes[w]
    digits, pass j's at shift j * log2(radix); every plane moves every
    pass.  One ``cuda_radix.sort_passes`` call: on a card one call into the
    kernel library enqueues one pass_histograms launch, which gives every
    pass's digit totals, and one onesweep_pass launch a pass, whose CTAs
    read the plan from the table on the card: a pass that one digit fills
    is the identity and returns at once (the JAX engine's ``lax.cond`` on
    ``max(totals) == padded``, the reference's CPU early-exit in
    CRadixSortCPU.h).  The passes that run ping-pong between two buffer
    sets, OUT and TMP, so that the last writes OUT; when none runs, the
    last launch copies the planes into OUT.  A narrow key plane (planes[0],
    the only key plane) of ``kind`` gives the digits of its image.  Returns
    OUT: the planes sorted, in storage of their own."""
    planes = tuple(planes)
    k = len(passes)
    outs, _ = cr.sort_passes(planes[:k], passes, planes[k:], radix, tile,
                             threads, kind)
    return outs


def key_word_planes(keys_bits: torch.Tensor):
    """Split sortable key bits (int32 or int64 container) into contiguous
    int32 word planes in LSD order: one for 32-bit keys, (lo, hi) for
    64-bit keys.  One span ``planes.split``."""
    with profiling.span("planes.split", bytes=keys_bits.nbytes):
        if keys_bits.element_size() == 4:
            return (keys_bits.contiguous(),)
        words = keys_bits.contiguous().view(torch.int32).view(-1, 2)
        return (words[:, 0].contiguous(), words[:, 1].contiguous())


def join_key_word_planes(word_planes, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`key_word_planes` into the ``dtype`` container.
    One span ``planes.join``."""
    with profiling.span("planes.join",
                        bytes=sum(p.nbytes for p in word_planes)):
        if len(word_planes) == 1:
            return word_planes[0]
        return torch.stack(tuple(word_planes), dim=1).view(dtype).view(-1)


def sort_planes(keys_bits: torch.Tensor, payload_planes=(), radix: int = 256,
                tile: int = _TILE, threads: int = _THREADS,
                total_bits: int | None = None):
    """Stable LSD sort of sortable key bits plus any number of int32 or
    int64 payload planes, all riding the same permutation every pass.

    ``total_bits`` caps the sorted key width when the caller knows every
    key is below 2**total_bits: fewer passes run, not just skipped.
    Returns (keys_bits_out, payload_planes_out), new tensors."""
    n = keys_bits.shape[0]
    payload_planes = tuple(payload_planes)
    if n == 0:
        return keys_bits.clone(), _empty_like_all(payload_planes)
    kplanes = key_word_planes(keys_bits)
    nk = len(kplanes)
    bits_per = radix.bit_length() - 1
    kbits = 8 * keys_bits.element_size() if total_bits is None else total_bits
    passes = tuple(-(-min(32, kbits - 32 * w) // bits_per) for w in range(nk)
                   if kbits > 32 * w)
    out = _sort_planes(kplanes + payload_planes, passes, radix, tile,
                       threads)
    return join_key_word_planes(out[:nk], keys_bits.dtype), out[nk:]


def sort_narrow_planes(keys: torch.Tensor, kind: str, payload_planes=(),
                       radix: int = 256, tile: int = _TILE,
                       threads: int = _THREADS):
    """Stable LSD sort of 1- or 2-byte keys given as the caller's own bits
    (``cuda_radix.NARROW_KEY_DTYPES``) of ``kind`` ("u", "i", "f"), plus
    int32 or int64 payload planes: one pass_histograms launch over the
    narrow key plane and one onesweep_pass for each pass (one a byte at
    radix 256), each a no-op where one digit fills it.  The kernels take
    the digits from the keys' sortable image and move their bits, so the
    sort ends with the caller's key bits in order and nothing to undo.
    Returns (keys_out, payload_planes_out), new tensors."""
    n = keys.shape[0]
    payload_planes = tuple(payload_planes)
    if n == 0:
        return keys.clone(), _empty_like_all(payload_planes)
    bits_per = radix.bit_length() - 1
    passes = (-(-8 * keys.element_size() // bits_per),)
    out = _sort_planes((keys.contiguous(),) + payload_planes, passes, radix,
                       tile, threads, kind)
    return out[0], out[1:]


def partition_planes(bucket_ids: torch.Tensor, planes_i32, num_buckets: int,
                     tile: int = _TILE, threads: int = _THREADS):
    """Stable partition of int32 (or int64) planes by bucket id: rows of
    bucket 0 first, each bucket in input order.

    ``bucket_ids`` must lie in [0, num_buckets) — a contract, not a checked
    precondition: the digit is ``ids & (radix - 1)``, so an id outside the
    range wraps into a low bucket (as in the JAX engine).  Up to 256
    buckets take one pass with the ids as the digit plane, not moved: one
    launch that reorders, or copies where every id is one bucket's; more
    buckets take LSD passes of 8 bits over the ids, which then move too.
    Nothing is read back to the host.
    Returns (partitioned planes, new tensors; counts (num_buckets,)
    int32)."""
    ids = bucket_ids.to(torch.int32).contiguous()
    planes = tuple(planes_i32)
    n = ids.numel()
    if n == 0:
        return _empty_like_all(planes), torch.zeros(
            num_buckets, dtype=torch.int32, device=ids.device)
    radix = max(2, _next_pow2(num_buckets))
    if radix <= 256:
        outs, table = cr.sort_passes((), (1,), planes, radix, tile, threads,
                                     digit=ids)
        return outs, table[0, :num_buckets]
    bits = radix.bit_length() - 1
    out = _sort_planes((ids,) + planes, (-(-bits // 8),), 256, tile, threads)
    return out[1:], bucket_counts(ids, num_buckets)


def bucket_counts(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """(num_buckets,) int32 rows of each id in [0, num_buckets), by
    ``scatter_add_`` into zeros: on a card ``torch.bincount`` sizes its
    output by a max it reads back to the host."""
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    return counts.scatter_add_(0, ids.to(torch.int64),
                               torch.ones_like(ids, dtype=torch.int32))


def payloads_to_planes(payloads):
    """Map 1-D payload tensors to planes: 4-byte dtypes view as one int32
    plane, 8-byte dtypes as one int64 plane (their bits: no copy of a
    contiguous column), narrower dtypes widen to one int32 plane (a 2-byte
    float by its bits).  Returns (planes, specs) for
    :func:`planes_to_payloads`.  One span ``planes.split``."""
    with profiling.span("planes.split",
                        bytes=sum(p.nbytes for p in payloads)):
        planes, specs = [], []
        for p in payloads:
            c = dtypes.as_container(p).contiguous()
            if c.dtype.itemsize == 4:
                planes.append(c.view(torch.int32))
            elif c.dtype.itemsize == 8:
                planes.append(c.view(torch.int64))
            else:
                if c.dtype.is_floating_point:  # widen the bits, not the value
                    c = c.view(torch.int16)
                planes.append(c.to(torch.int32))
            specs.append((p.dtype, c.dtype))
        return tuple(planes), tuple(specs)


def planes_to_payloads(planes, specs):
    """Inverse of :func:`payloads_to_planes`: a payload whose plane has its
    width comes back as a view of the plane, a widened payload narrowed.
    One span ``planes.join``."""
    with profiling.span("planes.join", bytes=sum(p.nbytes for p in planes)):
        out = []
        for plane, (dtype, container) in zip(planes, specs):
            if container.itemsize >= 4:
                c = plane.view(container)
            else:
                c = plane.to(container)
                if dtype.is_floating_point:
                    c = c.view(dtype)
            out.append(dtypes.from_container(c, dtype))
        return tuple(out)


def sort_biased(keys_bits: torch.Tensor, payloads,
                config: SortConfig = DEFAULT_CONFIG,
                total_bits: int | None = None):
    """Stable LSD radix sort of sortable key bits (int32/int64 containers,
    unsigned order; dtypes.to_sortable) with a tuple of payload tensors
    that ride the same permutation: the key's word planes and the payload
    planes through :func:`sort_planes`, which launches every pass; a
    pass's CTAs return at once on the card where one digit fills it.
    ``total_bits`` (default: the container's width) sets the passes.
    Returns (sorted key bits, payloads)."""
    planes, specs = payloads_to_planes(payloads)
    keys_out, planes_out = sort_planes(
        keys_bits, planes, radix=config.radix, tile=config.tile_elems,
        threads=config.threads_per_cta, total_bits=total_bits)
    return keys_out, planes_to_payloads(planes_out, specs)


def sort_narrow(keys: torch.Tensor, kind: str, payloads,
                config: SortConfig = DEFAULT_CONFIG):
    """Stable LSD radix sort of 1- or 2-byte keys given as the caller's own
    bits (a tensor of ``cuda_radix.NARROW_KEY_DTYPES``) of ``kind`` ("u",
    "i", "f"), with a tuple of payload tensors: the narrow counterpart of
    :func:`sort_biased`.  The kernels take each digit from the keys'
    sortable image in registers and move the keys' bits, so no transformed
    or widened key plane is made.  Returns (sorted keys of ``keys``' dtype,
    payloads)."""
    planes, specs = payloads_to_planes(payloads)
    keys_out, planes_out = sort_narrow_planes(
        keys, kind, planes, radix=config.radix, tile=config.tile_elems,
        threads=config.threads_per_cta)
    return keys_out, planes_to_payloads(planes_out, specs)
