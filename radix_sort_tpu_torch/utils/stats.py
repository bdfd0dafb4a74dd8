"""Timing statistics and runtime aggregation.

Port of ``radix_sort_tpu/utils/stats.py`` (the reference's ``CTimer``,
``Statistics`` and ``RuntimesGPU``/``RuntimesCPU``).  As in the reference,
device work is timed by bracketing a call that ends in a synchronisation;
here the callable synchronises the card itself (``harness.SortTask``).
The reference's ``Statistics`` never set ``min`` from the first sample
(an ``else if`` chain, ``src/Statistics.h:21-31``); that is fixed here, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
import time


class Timer:
    """Host wall-clock timer, seconds→ms like the reference's CTimer."""

    def __init__(self):
        self._t0 = None
        self._elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            raise RuntimeError("Timer.stop() before start()")
        self._elapsed = time.perf_counter() - self._t0
        self._t0 = None

    def elapsed_ms(self) -> float:
        return self._elapsed * 1e3


@dataclasses.dataclass
class Statistics:
    """Running min/max/avg/sum over samples (ms)."""

    n: int = 0
    total: float = 0.0
    min: float = math.inf
    max: float = -math.inf

    def update(self, value: float):
        # independent min/max updates: the first sample sets both
        self.n += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def avg(self) -> float:
        return self.total / self.n if self.n else 0.0

    def as_dict(self):
        return {"n": self.n, "avg": self.avg, "min": self.min, "max": self.max,
                "sum": self.total}


# Phase names follow the reference's four kernels (RadixSort.cl:16,125,185,74).
PHASES = ("histogram", "scan", "paste", "reorder")


@dataclasses.dataclass
class SortRuntimes:
    """Per-phase + total statistics for a sort run (RuntimesGPU parity).
    Per-phase numbers come only from ``SortTask.measure_phases``; ``total``
    is the end-to-end number."""

    histogram: Statistics = dataclasses.field(default_factory=Statistics)
    scan: Statistics = dataclasses.field(default_factory=Statistics)
    paste: Statistics = dataclasses.field(default_factory=Statistics)
    reorder: Statistics = dataclasses.field(default_factory=Statistics)
    total: Statistics = dataclasses.field(default_factory=Statistics)

    def phase(self, name: str) -> Statistics:
        return getattr(self, name)


@dataclasses.dataclass
class CpuRuntimes:
    """RuntimesCPU parity: the two host baselines."""

    stl: Statistics = dataclasses.field(default_factory=Statistics)  # np.sort
    radix: Statistics = dataclasses.field(default_factory=Statistics)


def time_callable_ms(fn, iterations: int = 5, warmup: int = 1) -> Statistics:
    """Run ``fn`` (which must block until its work is done) ``iterations``
    times, like TestPerformance (src/CRadixSortTask.cpp:355-437)."""
    for _ in range(warmup):
        fn()
    st = Statistics()
    t = Timer()
    for _ in range(iterations):
        t.start()
        fn()
        t.stop()
        st.update(t.elapsed_ms())
    return st
