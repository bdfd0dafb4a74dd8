"""Columnar batch — device-resident tables.

Port of ``radix_sort_tpu/table.py``, with the same contract: a Table has a
*static* row capacity (the tensors' length) and a *dynamic* ``num_rows``
(a 0-d int32 tensor on the columns' device), so operators with
data-dependent output sizes (filter, aggregate, join) never read a size
back to the host.  Rows at index >= num_rows are padding at the tail and
must be ignored; :meth:`to_numpy` slices them off at the host boundary.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from . import dtypes
from .status import EngineError, OperationStatus


class Table:
    """A batch of named, equal-length 1-D columns on one device."""

    def __init__(self, columns: Mapping[str, torch.Tensor],
                 num_rows: torch.Tensor | int | None = None):
        if not columns:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              "Table needs at least one column")
        cols = dict(columns)
        for name, c in cols.items():
            if c.ndim != 1:
                raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                                  f"column {name!r} must be 1-D")
        lengths = {c.shape[0] for c in cols.values()}
        if len(lengths) != 1:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              f"ragged columns: lengths {sorted(lengths)}")
        devices = {c.device for c in cols.values()}
        if len(devices) != 1:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              f"columns on several devices: {devices}")
        self.columns = cols
        self._capacity = next(iter(lengths))
        self.device = next(iter(devices))
        if num_rows is None:
            num_rows = self._capacity
        self.num_rows = torch.as_tensor(num_rows, device=self.device).to(
            torch.int32).reshape(())

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def column_names(self):
        return tuple(sorted(self.columns))

    def column(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.columns[name]

    def with_columns(self, **new_cols) -> "Table":
        """The same rows with columns added or replaced; ``num_rows`` is
        kept, and a column of another length or device raises."""
        return Table({**self.columns, **new_cols}, self.num_rows)

    def select(self, names) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.num_rows)

    def valid_mask(self) -> torch.Tensor:
        """Boolean mask of real (non-padding) rows."""
        return torch.arange(self._capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def head(self, n: int) -> "Table":
        """First min(n, num_rows) rows (LIMIT n); the capacity shrinks to n."""
        if n < 0:
            raise EngineError(OperationStatus.HOST_BUFFERS_FAILED,
                              f"head(n) needs n >= 0, got {n}")
        if n >= self._capacity:
            return Table(dict(self.columns), self.num_rows)
        return Table({k: v[:n] for k, v in self.columns.items()},
                     torch.clamp(self.num_rows, max=n))

    @classmethod
    def from_numpy(cls, columns: Mapping[str, np.ndarray],
                   num_rows: int | None = None, device="cuda") -> "Table":
        """Columns from numpy arrays (uint32/uint64 included), on
        ``device``: the card unless the caller asks for the CPU."""
        return cls({k: dtypes.tensor_from_numpy(v, device)
                    for k, v in columns.items()}, num_rows)

    def to_numpy(self) -> dict:
        n = int(self.num_rows)
        return {k: dtypes.tensor_to_numpy(v[:n])
                for k, v in self.columns.items()}

    def __repr__(self):
        cols = ", ".join(f"{k}:{v.dtype}"
                         for k, v in sorted(self.columns.items()))
        return f"Table[{cols}; capacity={self._capacity}]"
