"""Range-chunked sort: one partition into value ranges, then a sort of each.

Port of ``radix_sort_tpu/ops/chunked_sort.py``, an explicit engine
(``engine="chunked"``) that ``auto`` never picks, as in the JAX package
(``AUTO_CHUNKED_MIN_N = None`` there).

  1. sample    — strided key samples, radix-sorted; K - 1 order statistics
                 become range splitters.
  2. assign    — each key's chunk is its splitter interval.  Keys EQUAL to
                 a splitter spread over the tied chunk range by input
                 position (``lo + pos * width // n``, on n >> 8), which is
                 position-monotone, so the sort stays stable and an
                 all-equal input balances.
  3. partition — ONE stable pass of the radix kernels
                 (``stream.partition_planes``: K1 + K3/K4) moves every
                 plane to chunk-major order; above 256 chunks it takes two
                 8-bit passes.
  4. sort      — the chunks are contiguous runs of known length (one host
                 read of the counts), each sorted in place by the radix
                 kernels (``stream.sort_planes`` on the slice).  This is
                 the counterpart of the JAX batched ``lax.sort`` over a
                 (K, cap) batch and its stitch, which exist for static
                 shapes.

No chunk has a capacity, so none can overflow: ``slack`` is accepted for
the JAX signature and unused, and the JAX overflow fallback has no
counterpart.  The tie spread is computed in int64: the JAX int32 product
``pos_c * width`` wraps near n = 2^30 with k_chunks near 1024; the values
are the same wherever it does not.
"""

from __future__ import annotations

import torch

from .. import dtypes
from ..config import DEFAULT_CONFIG
from . import stream

MAX_CHUNKS = 1024


def _order_stat_splitters(samples_sorted: torch.Tensor,
                          k_chunks: int) -> torch.Tensor:
    m = samples_sorted.shape[0]
    idx = (torch.arange(1, k_chunks, device=samples_sorted.device) * m
           ) // k_chunks
    return samples_sorted[idx]


def _tie_spread(pos: torch.Tensor, n: int, lo: torch.Tensor,
                width: torch.Tensor) -> torch.Tensor:
    """lo + (pos >> 8) * width // max(1, n >> 8), in int64: the JAX
    spread without its int32 wrap (``pos`` are input positions < n)."""
    pos_c = pos.to(torch.int64) >> 8
    return lo.to(torch.int64) + (pos_c * width.to(torch.int64)
                                 ) // max(1, n >> 8)


def _chunk_destinations(keys_bits: torch.Tensor, splitters: torch.Tensor,
                        k_chunks: int) -> torch.Tensor:
    """Chunk id (int32) per key: its splitter interval; ties spread
    position-monotonically over the tied chunk range.  ``splitters`` are
    sortable bits in ascending unsigned order, so lo = #splitters < key and
    hi = #splitters <= key are binary searches on the signed image."""
    n = keys_bits.shape[0]
    spl = dtypes.signed_order(splitters).contiguous()
    key = dtypes.signed_order(keys_bits).contiguous()
    lo = torch.searchsorted(spl, key)
    hi = torch.searchsorted(spl, key, right=True)
    width = hi - lo + 1
    spread = _tie_spread(torch.arange(n, device=keys_bits.device), n, lo,
                         width)
    dest = torch.where(width > 1, torch.minimum(spread, hi), lo)
    return dest.to(torch.int32)


def sort_chunked_biased(keys_bits: torch.Tensor, payloads=(), *,
                        k_chunks: int = 8, slack: float = 1.30,
                        samples: int = 2048, stable: bool | None = None,
                        min_n: int = 1 << 18, total_bits: int | None = None,
                        config=DEFAULT_CONFIG):
    """Stable sort of sortable key bits (``dtypes.to_sortable``) and a tuple
    of payload tensors by range chunking.  Returns (keys, payloads) like
    ``sort_biased_kv``.

    Below ``min_n`` rows, with fewer than 2 chunks or chunks under 128 rows
    it is one radix sort.  ``k_chunks`` above 1024 raises ValueError, as in
    the JAX package.  Every sort is stable, so ``stable`` has no effect;
    ``slack`` is unused (see the module docstring)."""
    del slack, stable
    n = keys_bits.shape[0]
    if k_chunks > MAX_CHUNKS:
        raise ValueError(f"k_chunks must be <= {MAX_CHUNKS}, got {k_chunks}")
    K = k_chunks
    payloads = tuple(payloads)
    radix, tile = config.radix, config.tile_elems
    threads = config.threads_per_cta
    pay_planes, specs = stream.payloads_to_planes(payloads)
    if n < min_n or K < 2 or n // K < 128:
        ko, po = stream.sort_planes(keys_bits, pay_planes, radix, tile,
                                    threads, total_bits)
        return ko, stream.planes_to_payloads(po, specs)

    count = min(samples, n)
    smp = keys_bits[::max(1, n // count)][:count]
    smp_sorted, _ = stream.sort_planes(smp.contiguous(), (), radix, tile,
                                       threads, total_bits)
    dest = _chunk_destinations(keys_bits,
                               _order_stat_splitters(smp_sorted, K), K)

    kplanes = stream.key_word_planes(keys_bits)
    nk = len(kplanes)
    parted, counts = stream.partition_planes(dest, kplanes + pay_planes, K,
                                             tile, threads)
    # new storage, never the caller's: the chunk sorts below write in it
    keys_out = stream.join_key_word_planes(parted[:nk], keys_bits.dtype)
    pays_out = parted[nk:]
    stream.host_reads += 1  # the chunk sizes
    sizes = counts.tolist()
    lo = 0
    for size in sizes:
        if size > 1:
            hi = lo + size
            ko, po = stream.sort_planes(
                keys_out[lo:hi], tuple(p[lo:hi] for p in pays_out), radix,
                tile, threads, total_bits)
            keys_out[lo:hi] = ko
            for dst, src in zip(pays_out, po):
                dst[lo:hi] = src
        lo += size
    return keys_out, stream.planes_to_payloads(pays_out, specs)
