"""Columnar persistence: save and load Tables and batches of them.

Port of ``radix_sort_tpu/io.py``, in the same format, so a file written by
either package loads in the other:

- save_table / load_table — one Table ↔ one ``.npz``: every column over the
  whole capacity (padding rows included) plus ``__num_rows__``.
- BatchWriter / iter_batches — a numbered ``.npz`` per Table in a
  directory, with a ``manifest.json``, reloaded in order.

Columns cross to numpy through ``dtypes.tensor_to_numpy`` and back through
``dtypes.tensor_from_numpy``, so uint32/uint64 columns keep their dtype.
``device`` is where loaded tables live: the card unless the caller asks
for the CPU (the JAX package's ``device: bool``).
"""

from __future__ import annotations

import json
import os

import numpy as np

from . import dtypes
from .table import Table

_META = "__num_rows__"


def save_table(table: Table, path: str) -> str:
    """Write ``table`` to ``path`` (``.npz`` appended if missing); returns
    the path written."""
    cols = {k: dtypes.tensor_to_numpy(v) for k, v in table.columns.items()}
    cols[_META] = np.asarray([int(table.num_rows)], dtype=np.int64)
    path = path if path.endswith(".npz") else path + ".npz"
    np.savez(path, **cols)
    return path


def load_table(path: str, device="cuda") -> Table:
    with np.load(path) as z:
        num_rows = int(z[_META][0])
        cols = {k: dtypes.tensor_from_numpy(z[k], device)
                for k in z.files if k != _META}
    return Table(cols, num_rows=num_rows)


class BatchWriter:
    """Spill a sequence of Tables to numbered files in a directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self._count = 0

    def write(self, table: Table) -> str:
        path = os.path.join(self.directory, f"batch_{self._count:06d}.npz")
        save_table(table, path)
        self._count += 1
        return path

    def finish(self) -> str:
        manifest = os.path.join(self.directory, "manifest.json")
        with open(manifest, "w") as f:
            json.dump({"num_batches": self._count, "format": "npz-v1"}, f)
        return manifest


def iter_batches(directory: str, device="cuda"):
    with open(os.path.join(directory, "manifest.json")) as f:
        meta = json.load(f)
    for i in range(meta["num_batches"]):
        yield load_table(os.path.join(directory, f"batch_{i:06d}.npz"),
                         device=device)
