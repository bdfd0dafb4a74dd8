"""Stable multi-pass LSD radix sort — the engine's centrepiece.

Port of ``radix_sort_tpu/ops/sort.py``.  Keys go through the
order-preserving transform of ``dtypes.to_sortable`` (int32/int64
containers whose unsigned order is the key order), so every key type shares
one code path, and come back to the caller's dtype at the end.

Engines:
  - ``radix`` (= ``auto``): the LSD radix passes of ops/cuda_radix.py.  On a
    CUDA tensor every pass runs the CUDA kernels; on a CPU tensor it runs
    their plain torch versions.  Stable as it stands, so the JAX package's
    two-key trick for an unstable network has no counterpart.
  - ``merge``: the JAX package's ``pallas_merge`` engine, the tile sort and
    merge levels of ops/cuda_merge.py, for key-only sorts of 32-bit keys
    (u32, i32, f32).  Sorts with a payload (``argsort`` included), 64-bit
    keys and 16-bit keys run ``radix``, as the JAX engine sends them to
    ``xla_sort``: a dispatch by shape, not a fallback on failure.
  - ``torch_sort``: ``torch.sort(stable=True)``, the speed baseline on the
    same card.  ``auto`` never chooses it.

The JAX package's engine names are accepted too (``JAX_ENGINES``):
``pallas``, ``pallas_stream`` and ``xla_radix`` are all the JAX package's
stable LSD radix sort, so they run ``radix`` (the kernels on a CUDA
tensor); ``xla_sort`` is the platform's library sort, so it runs
``torch_sort``, chosen by that name and never as a fallback;
``pallas_merge`` runs ``merge``.  ``chunked`` is not ported yet and
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from .. import dtypes
from ..config import DEFAULT_CONFIG, SortConfig
from ..status import EngineError, OperationStatus
from . import cuda_merge, cuda_radix

ENGINES = ("auto", "radix", "merge", "torch_sort")
# JAX engine name -> the port's engine that does the same work
JAX_ENGINES = {"pallas": "radix", "pallas_stream": "radix",
               "xla_radix": "radix", "xla_sort": "torch_sort",
               "pallas_merge": "merge"}
NOT_YET_PORTED = ("chunked",)


def _dispatch_engine(engine: str) -> str:
    engine = JAX_ENGINES.get(engine, engine)
    if engine == "auto":
        return "radix"
    if engine in ENGINES:
        return engine
    if engine in NOT_YET_PORTED:
        raise EngineError(OperationStatus.INITIALIZATION_FAILED,
                          f"engine {engine!r} is not yet ported")
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
    is the key width when it is narrower than the container (16-bit keys
    in int32)."""
    payloads = tuple(payloads)
    engine = _dispatch_engine(config.engine)
    bits = 8 * keys_bits.element_size() if total_bits is None else total_bits
    if engine == "merge" and not payloads and bits == 32:
        return cuda_merge.merge_sort_bits(keys_bits), ()
    if engine in ("radix", "merge"):
        return cuda_radix.sort_biased(keys_bits, payloads, config, total_bits)
    return _torch_sort_engine(keys_bits, payloads)


def _sort_impl(keys: torch.Tensor, payloads, config: SortConfig):
    if keys.ndim != 1:
        raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                          f"keys must be 1-D, got shape {tuple(keys.shape)}")
    ku, pls = sort_biased_kv(dtypes.to_sortable(keys), payloads, config,
                             dtypes.key_bits(keys.dtype))
    return dtypes.from_sortable(ku, keys.dtype), pls


def sort(keys: torch.Tensor, config: SortConfig = DEFAULT_CONFIG,
         engine: str | None = None) -> torch.Tensor:
    """Key-only sort (ascending, stable)."""
    if engine is not None:
        config = dataclasses.replace(config, engine=engine)
    out, _ = _sort_impl(keys, (), config)
    return out


def sort_kv(keys: torch.Tensor, values: Any,
            config: SortConfig = DEFAULT_CONFIG, engine: str | None = None):
    """Key-value sort: ``values`` is a pytree (dict, tuple, list or one
    tensor) of 1-D tensors as long as ``keys``; every leaf is permuted with
    the keys, stably."""
    if engine is not None:
        config = dataclasses.replace(config, engine=engine)
    leaves, spec = pytree.tree_flatten(values)
    for leaf in leaves:
        if leaf.shape[0] != keys.shape[0]:
            raise EngineError(
                OperationStatus.HOST_BUFFERS_FAILED,
                f"value leaf length {leaf.shape[0]} != keys {keys.shape[0]}")
    out_keys, out_leaves = _sort_impl(keys, tuple(leaves), config)
    return out_keys, pytree.tree_unflatten(list(out_leaves), spec)


def argsort(keys: torch.Tensor, config: SortConfig = DEFAULT_CONFIG,
            engine: str | None = None) -> torch.Tensor:
    """Stable argsort (int32 permutation)."""
    iota = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    _, perm = sort_kv(keys, iota, config=config, engine=engine)
    return perm
