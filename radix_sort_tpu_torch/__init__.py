"""radix_sort_tpu_torch — the query-execution engine on PyTorch and CUDA.

Port of ``radix_sort_tpu`` (JAX on a TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).  This package imports torch and numpy,
never JAX; the JAX package stays beside it as the reference that the port's
tests hold it against.

Public API (the slice ported so far):
    sort, sort_kv, argsort         — stable LSD radix sort, and the merge
                                     sort for key-only 32-bit keys
                                     (ops/sort.py)
    top_k, top_k_kv                — ordered selection (ops/topk.py)
    SortConfig                     — tuning parameters (config.py)
    Table                          — columnar batch (table.py)
    filter/aggregate/join ops      — ops/
    convert                        — tables and configs from the JAX package
    harness, utils                 — the reference's task harness, CSV rows,
                                     CLI options and timing
"""

from .config import SortConfig, DEFAULT_CONFIG
from .status import OperationStatus, EngineError
from .ops.sort import sort, sort_kv, argsort
from .ops.topk import top_k, top_k_kv
from .table import Table
from . import convert, datasets, golden, dtypes

__version__ = "0.1.0"

__all__ = [
    "sort", "sort_kv", "argsort", "top_k", "top_k_kv",
    "Table",
    "SortConfig", "DEFAULT_CONFIG",
    "OperationStatus", "EngineError",
    "convert", "datasets", "golden", "dtypes",
    "__version__",
]
