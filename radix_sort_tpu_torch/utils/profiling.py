"""Profiling / observability utilities.

Port of ``radix_sort_tpu/utils/profiling.py``:

- :func:`time_ms` — the time of one call of a function: CUDA events on a
  card (the device's own clock; no transport to work around, so the JAX
  package's ``chained_time`` has no counterpart), ``perf_counter`` on the
  CPU.  The device is explicit: nothing here picks a card.
- :func:`trace` — ``torch.profiler`` over the enclosed work, written as a
  trace that TensorBoard or Perfetto open, inside an NVTX range on a card.
- :func:`roofline` — achieved bytes/s over the card's memory bandwidth.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

# Memory bandwidth of one card, GB/s, by torch.cuda.get_device_name()
# prefix (NVIDIA's data sheets; SXM parts).
HBM_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H200": 4800.0,
}


def device_hbm_gbs(device) -> float | None:
    """The card's memory bandwidth in GB/s, None off a card or for an
    unlisted one."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for prefix, bw in HBM_GBS.items():
        if name.startswith(prefix):
            return bw
    return None


def time_ms(fn, device, reps: int = 3, warmup: int = 1) -> float:
    """Median time of one call of ``fn`` on ``device``, in ms."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if on_card:
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


@contextlib.contextmanager
def trace(logdir: str, name: str = "radix_sort_tpu_torch"):
    """Profile the enclosed work (CPU, and the card where there is one)
    inside a range called ``name`` (``record_function``, and NVTX on a
    card) and write the trace under ``logdir``.  Yields the profiler, whose
    ``key_averages()`` sums device time by kernel."""
    on_card = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)) as prof:
        if on_card:
            torch.cuda.nvtx.range_push(name)
        try:
            with torch.profiler.record_function(name):
                yield prof
        finally:
            if on_card:
                torch.cuda.nvtx.range_pop()


def roofline(bytes_moved: int, seconds: float, device) -> float | None:
    """Fraction of the card's memory roofline achieved (None if unknown)."""
    bw = device_hbm_gbs(device)
    if bw is None or seconds <= 0:
        return None
    return (bytes_moved / seconds) / (bw * 1e9)


def sort_min_bytes(n: int, key_dtype, bits_per_pass: int = 8,
                   payload_bytes: int = 0) -> int:
    """Speed-of-light traffic for an LSD radix sort: one read + one write of
    keys (+ payload) per pass, plus a digit-read for the histogram pass."""
    kb = np.dtype(key_dtype).itemsize
    passes = (kb * 8) // bits_per_pass
    row = kb + payload_bytes
    return passes * n * (2 * row + kb)
