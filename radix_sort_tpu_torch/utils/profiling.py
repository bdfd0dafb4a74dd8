"""Profiling / observability utilities.

Port of ``radix_sort_tpu/utils/profiling.py``:

- :func:`time_ms` / :func:`call_times` — the time of one call of a
  function: CUDA events on a card (the device's own clock; no transport to
  work around, so the JAX package's ``chained_time`` has no counterpart),
  ``perf_counter`` on the CPU.  The device is explicit: nothing here picks
  a card.  :func:`rank_ms` times a call of every rank of a mesh.
- :func:`device_info` — the card's name and power limit.
- :func:`span` — the program's spans: a named interval of host time
  around one layer's work (a query step, a word-plane copy, a sort), off
  until :func:`enable` and handed out by :func:`take_spans`.
- :func:`trace` — ``torch.profiler`` over the enclosed work with the spans
  on, written as one Chrome trace that TensorBoard or Perfetto open: the
  spans beside the device rows on one time base, inside an NVTX range on a
  card.
- :func:`roofline` — achieved bytes/s over the card's memory bandwidth.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
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


def call_times(fn, device, reps: int = 3, warmup: int = 1) -> list:
    """The time of each of ``reps`` calls of ``fn`` on ``device`` after
    ``warmup`` calls, in ms: CUDA events around the call on a card (the
    host work of the call inside the window), the host clock on the
    CPU."""
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
    return times


def time_ms(fn, device, reps: int = 3, warmup: int = 1) -> float:
    """Median time of one call of ``fn`` on ``device``, in ms."""
    return float(np.median(call_times(fn, device, reps, warmup)))


def rank_ms(fn, mesh, reps: int = 3, warmup: int = 1) -> float:
    """The slowest rank's median host-clock ms of ``fn`` over ``reps``
    calls after ``warmup``: each call starts after a barrier of the mesh
    and ends by a synchronize of the rank's card.  Every rank of the mesh
    calls it (one all_reduce of max)."""
    import torch.distributed as dist

    on_card = mesh.device.type == "cuda"
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        dist.barrier(group=mesh.group)
        if on_card:
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        fn()
        if on_card:
            torch.cuda.synchronize(mesh.device)
        times.append((time.perf_counter() - t0) * 1e3)
    t = torch.tensor([float(np.median(times))], dtype=torch.float64,
                     device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t[0])


def device_info(device) -> dict:
    """``{"name", "power_limit_w"}`` of ``device``: the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` reads them
    (the limit None where nvidia-smi cannot be read), ``"cpu"`` and None
    off a card.  Every number a program reports stands beside these."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    name, limit = torch.cuda.get_device_name(index), None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=30).stdout
        limit = float(out.strip().splitlines()[0].rsplit(",", 1)[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"name": name, "power_limit_w": limit}


# ------------------------------------------------------------------ spans
#
# A span's start and end are ``time.time_ns()``: CLOCK_REALTIME, the
# clock torch.profiler stamps its events with (c10::getTime on Linux;
# Kineto converts CUPTI's device timestamps to it), so a span lines up
# with the device rows of a trace taken meanwhile.  Read through ``_now``
# alone, so that a test can count the reads.
_now = time.time_ns


@dataclasses.dataclass(frozen=True)
class Span:
    """One finished span: ``name``; ``start_ns`` and ``end_ns`` on the
    profiler's clock; its ``id``; the id of the span it opened in
    (``parent``, None for an outermost span); ``call``, an id that the
    outermost span opens and every span nested in it shares; ``attrs``,
    host-known sizes (rows, planes, bytes from shapes), never a value read
    back from the card."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    call: int
    attrs: dict


class _Off:
    """The one context every span is while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    """The process's spans: those finished (as tuples of :class:`Span`'s
    fields, made into spans when taken), the stack of those open (spans
    nest on the thread that runs the program), the next span and call
    ids."""

    def __init__(self):
        self.done = []
        self.open = []
        self.next_id = 0
        self.next_call = 0


class _Open:
    """A span while spans are on; it is recorded when it closes, an
    exception or not."""

    __slots__ = ("rec", "name", "attrs", "id", "parent", "call", "start")

    def __init__(self, rec: _Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        rec = self.rec
        self.id = rec.next_id
        rec.next_id += 1
        if rec.open:
            top = rec.open[-1]
            self.parent, self.call = top.id, top.call
        else:
            self.parent, self.call = None, rec.next_call
            rec.next_call += 1
        rec.open.append(self)
        self.start = _now()
        return self

    def __exit__(self, *exc):
        end = _now()
        self.rec.open.remove(self)
        self.rec.done.append((self.name, self.start, end, self.id,
                              self.parent, self.call, self.attrs))
        return False


_recorder = _Recorder()
_on = False


def span(name: str, **attrs):
    """A context manager that records ``name``'s span of host time while
    spans are on (:func:`enable`).  Off, it is one shared no-op context:
    no clock read, no allocation, no lock.  ``attrs`` are host-known
    sizes only (rows, planes, bytes from shapes)."""
    if not _on:
        return _OFF
    return _Open(_recorder, name, attrs)


def enable() -> None:
    """Turn spans on."""
    global _on
    _on = True


def disable() -> None:
    """Turn spans off; the spans recorded stay until :func:`take_spans`."""
    global _on
    _on = False


def take_spans() -> list:
    """Every :class:`Span` finished since the last call, in the order they
    opened; they are handed out once."""
    done, _recorder.done = _recorder.done, []
    return [Span(*s) for s in sorted(done, key=lambda s: s[3])]


# the row of a Chrome trace the spans go to: a thread id no OS thread has
_SPAN_TID = 0


def _write_trace(prof, logdir: str, spans) -> str:
    """``prof``'s Chrome trace under ``logdir`` (named as TensorBoard's
    handler names it), with ``spans`` added as complete events of a row
    "program spans" on the trace's own time base; returns its path."""
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # Kineto writes each ts in us from baseTimeNanoseconds (an older one
    # from the epoch)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    rows = doc.setdefault("traceEvents", [])
    rows.append({"ph": "M", "name": "thread_name", "pid": pid,
                 "tid": _SPAN_TID, "args": {"name": "program spans"}})
    for s in spans:
        rows.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                     "tid": _SPAN_TID, "ts": (s.start_ns - base) / 1e3,
                     "dur": (s.end_ns - s.start_ns) / 1e3,
                     "args": {"id": s.id, "parent": s.parent,
                              "call": s.call, **s.attrs}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@contextlib.contextmanager
def trace(logdir: str, name: str = "radix_sort_tpu_torch"):
    """Profile the enclosed work (CPU, and the card where there is one)
    with the program's spans on, inside a range called ``name``
    (``record_function``, and NVTX on a card), and write one Chrome trace
    under ``logdir``: the profiler's rows and the spans recorded meanwhile
    (taken, :func:`take_spans`), on one time base, so that Perfetto or
    TensorBoard show each span over the device work it launched.  Yields
    the profiler, whose ``key_averages()`` sums device time by kernel."""
    on_card = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was_on = _on
    enable()
    try:
        with torch.profiler.profile(
                activities=acts,
                on_trace_ready=lambda p: _write_trace(
                    p, logdir, take_spans())) as prof:
            if on_card:
                torch.cuda.nvtx.range_push(name)
            try:
                with torch.profiler.record_function(name):
                    yield prof
            finally:
                if on_card:
                    torch.cuda.nvtx.range_pop()
    finally:
        if not was_on:
            disable()


def roofline(bytes_moved: int, seconds: float, device) -> float | None:
    """Fraction of the card's memory roofline achieved (None if unknown)."""
    bw = device_hbm_gbs(device)
    if bw is None or seconds <= 0:
        return None
    return (bytes_moved / seconds) / (bw * 1e9)


def sort_min_bytes(n: int, key_dtype, bits_per_pass: int = 8,
                   payload_bytes: int = 0, passes: int | None = None) -> int:
    """Speed-of-light traffic for an LSD radix sort: one read + one write of
    keys (+ payload) per pass, plus a digit-read for the histogram pass.
    ``passes`` is the passes the sort runs (default: every pass of the
    key width)."""
    kb = np.dtype(key_dtype).itemsize
    if passes is None:
        passes = (kb * 8) // bits_per_pass
    row = kb + payload_bytes
    return passes * n * (2 * row + kb)


def radix_passes_run(keys: np.ndarray, bits_per_pass: int = 8) -> int:
    """The passes the radix engine runs on ``keys``: it skips every pass
    whose digit is the same in every key (``ops/stream._sort_planes``), so
    a pass runs where some key differs from the first in its digit."""
    from .. import dtypes

    if keys.size == 0:
        return 0
    u = dtypes.np_to_sortable_unsigned(keys)
    varying = int(np.bitwise_or.reduce(u ^ u[0]))
    mask = (1 << bits_per_pass) - 1
    return sum(1 for shift in range(0, 8 * u.itemsize, bits_per_pass)
               if (varying >> shift) & mask)
