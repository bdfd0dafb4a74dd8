"""Device events of a profiled stretch of the window, and their reduction.

``capture`` runs calls under ``torch.profiler`` (CUDA activity only on a
card, so the profiler adds no host-side op records to the calls it
watches) and returns a :class:`Trace`: every device kernel, memset and
memcpy as (name, start us, end us, kind), the span of the stretch and the
calls in it.  The span runs on the device's timeline, from the first
event's start to the last one's end: the idle time between calls is in
it, the profiler's own start and stop are not (on an H100 the host span
of a 1-s stretch took in up to ~0.3 s of them).  On the CPU, where the tests
run, torch's CPU ops stand in for device events.  torch.profiler on an
H100 now and then returns a session with no device rows; the caller then
calls ``capture`` again."""

from __future__ import annotations

import dataclasses
import re
import time

import torch

from . import window

KERNEL, MEMSET, MEMCPY = "kernel", "memset", "memcpy"
# kernels of PyTorch's own CUDA library (ATen, c10, cub, thrust): their
# names carry one of these namespaces, in the kernel's own name or in the
# functor it is instantiated with
_LIBRARY = re.compile(r"\b(at|c10|cub|thrust|at_cuda_detail)::")
# CUPTI synchronisation records are waits, not work on the device
_NOT_WORK = ("Sync", "Stream Wait")


@dataclasses.dataclass
class Trace:
    events: list          # (name, start_us, end_us, kind)
    span_us: float        # first event's start to the last event's end
    calls: int

    def busy_us(self) -> float:
        return window.union_length([(a, b) for _, a, b, _ in self.events])

    def idle_share(self) -> float:
        return 1.0 - self.busy_us() / self.span_us

    def work_us(self) -> float:
        """Device time outside NCCL's kernels: what a rank computes.  A
        NCCL kernel also runs while it waits for a slower peer, so on
        several cards device-busy time reads alike on every rank."""
        return window.union_length([(a, b) for n, a, b, _ in self.events
                                    if not is_collective(n)])


def kind_of(name: str) -> str | None:
    if name.startswith("Memset"):
        return MEMSET
    if name.startswith("Memcpy"):
        return MEMCPY
    if any(w in name for w in _NOT_WORK):
        return None
    return KERNEL


def is_library(name: str) -> bool:
    """A kernel of PyTorch's own library (not the program's)."""
    return bool(_LIBRARY.search(name))


def is_collective(name: str) -> bool:
    """A kernel of NCCL, the collectives between cards (not the
    program's)."""
    return name.startswith("nccl")


def per_call_ms(trace: Trace, pred) -> float:
    """Device ms a call in the events ``pred(name, kind)`` keeps."""
    us = sum(b - a for n, a, b, k in trace.events if pred(n, k))
    return us / 1e3 / trace.calls


def capture(step, sync, seconds: float, device, max_calls: int,
            min_calls: int = 3, agree=None) -> Trace:
    """Profile calls of ``step`` (one call each) for ``seconds`` of the
    host clock, at least ``min_calls`` and at most ``max_calls``, then
    ``sync``.  ``agree`` turns this process's decision to make another
    call into the one every rank acts on (rank 0's, on several cards)."""
    on_card = torch.device(device).type == "cuda"
    act = (torch.profiler.ProfilerActivity.CUDA if on_card
           else torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=[act]) as prof:
        sync()
        c0 = time.perf_counter()
        calls = 0
        while (agree or bool)(
                calls < max_calls and (calls < min_calls or
                                       time.perf_counter() - c0 < seconds)):
            step()
            calls += 1
        sync()
    events = []
    want = torch.autograd.DeviceType.CUDA if on_card else None
    for e in prof.events():
        if on_card and e.device_type != want:
            continue
        kind = kind_of(e.name)
        if kind is None or e.time_range.end <= e.time_range.start:
            continue
        events.append((e.name, float(e.time_range.start),
                       float(e.time_range.end), kind))
    span = (max(b for _, _, b, _ in events) - min(a for _, a, _, _ in events)
            if events else 0.0)
    return Trace(events, span, calls)


def top_ops(trace: Trace, limit: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by = {}
    for name, a, b, _ in trace.events:
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
            [:limit]]


def top_gaps(trace: Trace, limit: int = 10) -> list:
    """[name, seconds] of the device's idle gaps between the first and the
    last event, summed by the operation that ended each gap ("before
    <op>"): what the host was preparing while the device waited."""
    if not trace.events:
        return []
    ivals = [(a, b) for _, a, b, _ in trace.events]
    lo = min(a for a, _ in ivals)
    hi = max(b for _, b in ivals)
    by = {}
    for a, b, i in window.gaps(ivals, lo, hi):
        name = "before " + (trace.events[i][0] if i is not None else "end")
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
            [:limit]]
