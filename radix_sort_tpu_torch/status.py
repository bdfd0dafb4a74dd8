"""Operation status codes, the same values as the JAX package's
``radix_sort_tpu/status.py`` (parity with the reference's
``src/OperationStatus.h:4-17``)."""

from __future__ import annotations

import enum


class OperationStatus(enum.Enum):
    OK = 0
    HOST_BUFFERS_FAILED = 1
    INITIALIZATION_FAILED = 2
    DATA_UPLOAD_FAILED = 3
    DATA_DOWNLOAD_FAILED = 4
    CALCULATION_FAILED = 5
    CLEANUP_FAILED = 6
    RESIZE_FAILED = 7
    KERNEL_CREATION_FAILED = 8
    PROGRAM_CREATION_FAILED = 9
    NO_SOURCE_FOUND = 10
    LOADING_SOURCE_FAILED = 11
    COMPILATION_FAILED = 12
    SHARDING_FAILED = 13
    VALIDATION_FAILED = 14


class EngineError(RuntimeError):
    """Raised by the engine with an attached :class:`OperationStatus`."""

    def __init__(self, status: OperationStatus, message: str = ""):
        super().__init__(f"{status.name}: {message}" if message else status.name)
        self.status = status
