"""Carry data and settings from the JAX package into the port.

The JAX package's ``Table.to_numpy()`` / ``Table.columns`` give numpy
arrays (uint32/uint64 columns included) and its ``SortConfig`` is a
dataclass; these turn them into the port's objects, so the same tables go
through both packages.  Nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .config import SortConfig
from .table import Table

# Fields of the JAX SortConfig the port has no counterpart for: the TPU
# tile, and an iteration count that nothing reads (the harness takes its
# count from RadixSortOptions.iterations, as in the JAX package).
DROPPED_FIELDS = ("block_elems", "perf_iterations")
# JAX engine names whose port has another name.
ENGINE_NAMES = {"pallas_merge": "merge"}


def table_from_numpy(columns: Mapping[str, np.ndarray], num_rows=None,
                     device="cpu") -> Table:
    """numpy columns (+ the JAX table's ``num_rows``) → the port's Table on
    ``device``.  uint32/uint64 columns cross as their signed containers and
    keep their dtype; ``Table.to_numpy()`` gives them back unchanged."""
    if num_rows is not None:
        num_rows = int(np.asarray(num_rows))
    return Table.from_numpy(columns, num_rows=num_rows, device=device)


def sort_config_from_fields(fields: Mapping) -> SortConfig:
    """``dataclasses.asdict(jax SortConfig)`` → the port's SortConfig,
    dropping DROPPED_FIELDS and renaming the engine by ENGINE_NAMES; the
    kernel tile keeps its default."""
    known = {f.name for f in dataclasses.fields(SortConfig)}
    unknown = set(fields) - known - set(DROPPED_FIELDS)
    if unknown:
        raise ValueError(f"unknown SortConfig fields {sorted(unknown)}")
    kw = {k: v for k, v in fields.items() if k in known}
    if "engine" in kw:
        kw["engine"] = ENGINE_NAMES.get(kw["engine"], kw["engine"])
    return SortConfig(**kw)
