"""radix_sort_tpu_torch — the query-execution engine on PyTorch and CUDA.

Port of ``radix_sort_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).  This package imports torch and numpy,
never JAX; the JAX package stays beside it as the reference that the port's
tests hold it against.

Public API (the slice ported so far):
    sort, sort_kv, argsort         — stable LSD radix sort (ops/sort.py)
    SortConfig                     — tuning parameters (config.py)
    Table                          — columnar batch (table.py)
    filter/aggregate/join ops      — ops/
    convert                        — tables and configs from the JAX package
"""

from .config import SortConfig, DEFAULT_CONFIG
from .status import OperationStatus, EngineError
from .ops.sort import sort, sort_kv, argsort
from .table import Table
from . import convert, datasets, golden, dtypes

__version__ = "0.1.0"

__all__ = [
    "sort", "sort_kv", "argsort",
    "Table",
    "SortConfig", "DEFAULT_CONFIG",
    "OperationStatus", "EngineError",
    "convert", "datasets", "golden", "dtypes",
    "__version__",
]
