"""Stable multi-pass LSD radix sort — the engine's centrepiece.

Port of ``radix_sort_tpu/ops/sort.py``.  Keys go through the
order-preserving transform of ``dtypes.to_sortable`` (int32/int64
containers whose unsigned order is the key order), so every key type shares
one code path, and come back to the caller's dtype at the end.  1- and
2-byte keys under ``radix`` and ``merge`` are the exception: the kernels
take the caller's bits at their own width and the image in registers
(``stream.sort_narrow``), so no transform runs and no int32 key plane
is made.  The operators' sorts of a table by one column take their key
from :func:`padded_key`: the sortable image on valid rows, the sentinel on
padding, so padding sorts last.

Engines:
  - ``radix`` (= ``auto``): the LSD radix passes of ops/cuda_radix.py,
    through the plane format of ops/stream.py.  On a CUDA tensor every
    pass runs the CUDA kernels; on a CPU tensor it runs their plain torch
    versions.  Stable as it stands, so the JAX package's
    two-key trick for an unstable network has no counterpart.
  - ``merge``: the JAX package's ``pallas_merge`` engine, the tile sort and
    merge levels of ops/cuda_merge.py, for key-only sorts of 32-bit keys
    (u32, i32, f32).  Sorts with a payload (``argsort`` included), 64-bit
    keys and 8- and 16-bit keys run ``radix``, as the JAX engine sends
    them to ``xla_sort``: a dispatch by shape, not a fallback on failure.
  - ``torch_sort``: ``torch.sort(stable=True)``, the speed baseline on the
    same card.  ``auto`` never chooses it.

The JAX package's engine names are accepted too (``JAX_ENGINES``):
``pallas``, ``pallas_stream`` and ``xla_radix`` are all the JAX package's
stable LSD radix sort, so they run ``radix`` (the kernels on a CUDA
tensor); ``xla_sort`` is the platform's library sort, so it runs
``torch_sort``, chosen by that name and never as a fallback;
``pallas_merge`` runs ``merge``.  ``chunked`` (the same name in both
packages) is the range-chunked sort of ops/chunked_sort.py: one partition
pass into value ranges, then a radix sort of each; only a caller who names
it gets it, as in the JAX package, where ``auto`` never picks it.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from ..utils import profiling
from . import chunked_sort, cuda_merge, stream

ENGINES = ("auto", "radix", "merge", "torch_sort", "chunked")
# JAX engine name -> the port's engine that does the same work
JAX_ENGINES = {"pallas": "radix", "pallas_stream": "radix",
               "xla_radix": "radix", "xla_sort": "torch_sort",
               "pallas_merge": "merge", "chunked": "chunked"}


def _dispatch_engine(engine: str) -> str:
    engine = JAX_ENGINES.get(engine, engine)
    if engine == "auto":
        return "radix"
    if engine in ENGINES:
        return engine
    raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                      f"unknown engine {engine!r}")


def _torch_sort_engine(keys_bits: torch.Tensor, payloads):
    order = torch.sort(dtypes.signed_order(keys_bits), stable=True).indices
    return keys_bits[order], tuple(
        dtypes.from_container(dtypes.as_container(p)[order], p.dtype)
        for p in payloads)


def sort_biased_kv(keys_bits: torch.Tensor, payloads,
                   config: SortConfig = DEFAULT_CONFIG,
                   total_bits: int | None = None):
    """Engine-dispatched stable sort of sortable key bits (already through
    ``dtypes.to_sortable``) with a tuple of payload tensors.  ``total_bits``
    is the key width when it is narrower than the container (8- and
    16-bit keys in int32): that many bits of digits are sorted."""
    payloads = tuple(payloads)
    engine = _dispatch_engine(config.engine)
    bits = 8 * keys_bits.element_size() if total_bits is None else total_bits
    if engine == "merge" and not payloads and bits == 32:
        return cuda_merge.merge_sort_bits(keys_bits), ()
    if engine in ("radix", "merge"):
        return stream.sort_biased(keys_bits, payloads, config, total_bits)
    if engine == "chunked":
        return chunked_sort.sort_chunked_biased(
            keys_bits, payloads, total_bits=total_bits, config=config)
    return _torch_sort_engine(keys_bits, payloads)


def padded_key(col: torch.Tensor, valid: torch.Tensor,
               descending: bool = False) -> torch.Tensor:
    """The sort key of a table's column ``col`` whose real rows are
    ``valid`` (``Table.valid_mask()``, which the caller already holds):
    the sortable image (``dtypes.to_sortable``), complemented within the
    key's width when ``descending``, on valid rows and
    ``dtypes.SENTINEL_BITS`` on padding, so a stable sort puts padding
    last, after every real row of the sentinel's value."""
    image = dtypes.to_sortable(col)
    if descending:
        image = dtypes.complement(image, dtypes.key_bits(col.dtype))
    return torch.where(valid, image, dtypes.SENTINEL_BITS)


def _sort_impl(keys: torch.Tensor, payloads, config: SortConfig):
    if keys.ndim != 1:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"keys must be 1-D, got shape {tuple(keys.shape)}")
    d = dtypes.key_dtype(keys.dtype)
    if d.itemsize < 4 and _dispatch_engine(config.engine) in ("radix",
                                                              "merge"):
        # the kernels take the caller's bits at their own width and the
        # image in registers: no transform, no int32 key plane
        ko, pls = stream.sort_narrow(dtypes.as_container(keys), d.kind,
                                     tuple(payloads), config)
        return dtypes.from_container(ko, keys.dtype), pls
    ku, pls = sort_biased_kv(dtypes.to_sortable(keys), payloads, config,
                             dtypes.key_bits(keys.dtype))
    return dtypes.from_sortable(ku, keys.dtype), pls


def sort(keys: torch.Tensor, config: SortConfig = DEFAULT_CONFIG,
         engine: str | None = None) -> torch.Tensor:
    """Key-only sort (ascending, stable); one span ``sort``."""
    with profiling.span("sort", rows=keys.shape[0]):
        if engine is not None:
            config = dataclasses.replace(config, engine=engine)
        out, _ = _sort_impl(keys, (), config)
    return out


def sort_kv(keys: torch.Tensor, values: Any,
            config: SortConfig = DEFAULT_CONFIG, engine: str | None = None):
    """Key-value sort: ``values`` is a pytree (dict, tuple, list or one
    tensor) of 1-D tensors as long as ``keys``; every leaf is permuted with
    the keys, stably.  One span ``sort_kv``."""
    with profiling.span("sort_kv", rows=keys.shape[0]):
        if engine is not None:
            config = dataclasses.replace(config, engine=engine)
        leaves, spec = pytree.tree_flatten(values)
        for leaf in leaves:
            if leaf.shape[0] != keys.shape[0]:
                raise EngineError(
                    OperationStatus.HOST_BUFFERS_FAILED,
                    f"value leaf length {leaf.shape[0]} != keys "
                    f"{keys.shape[0]}")
        out_keys, out_leaves = _sort_impl(keys, tuple(leaves), config)
        return out_keys, pytree.tree_unflatten(list(out_leaves), spec)


def _iota(n: int, device) -> torch.Tensor:
    """0 .. n - 1 as int32, by one broadcast add of two short aranges:
    torch's arange kernel writes 2^27 int32 in 1.26 ms on an H100 (~0.4
    TB/s; scripts/narrow_pass_probe.py), a whole argsort of 8-bit keys'
    worth."""
    w = 1024
    hi = torch.arange(-(-n // w), dtype=torch.int32, device=device) * w
    lo = torch.arange(w, dtype=torch.int32, device=device)
    return (hi[:, None] + lo).view(-1)[:n]


def argsort(keys: torch.Tensor, config: SortConfig = DEFAULT_CONFIG,
            engine: str | None = None) -> torch.Tensor:
    """Stable argsort (int32 permutation); one span ``argsort``, the
    ``sort_kv`` span inside it."""
    with profiling.span("argsort", rows=keys.shape[0]):
        _, perm = sort_kv(keys, _iota(keys.shape[0], keys.device),
                          config=config, engine=engine)
    return perm
