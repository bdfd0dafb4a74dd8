"""The stretch with the program's spans on, and its device time and idle
gaps put down to the spans that caused them.

A traced run profiles one stretch of its window with the program's spans
off (``core.drive``); every reader of the device trace reads that one.
The readers of the program's spans (``metrics/*.py`` with the source
``program_span``) read a second stretch, taken once a run by
:func:`stretch` after the run's window and check: the cell's inputs made
again from the run's seed, the mix prepared and warmed up, then
``core.PROFILE_S`` seconds of the same closed loop of calls profiled with
the program's spans on (``radix_sort_tpu_torch.utils.profiling``).  A
program without spans (no ``profiling.take_spans``) takes no second
stretch, and its readers return None.

The program's spans are host intervals on the clock torch.profiler stamps
its events with.  A device event belongs to the innermost span open when
the host launched it (the CUDA runtime record with the event's
correlation id); an idle gap on the device timeline belongs, for each
part of it, to the innermost span open on the host meanwhile, and to the
caller where none was.  The stretch's table of device and idle ms by span
(:func:`span_table`) goes to standard error as one line,
``span_breakdown <json>``, before the run's check lines."""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import json
import sys
import time

import torch

from . import core, window
from .trace import Trace, kind_of


@dataclasses.dataclass
class SpanTrace:
    """A profiled stretch with the program's spans on.  ``trace`` holds its
    device events as the first stretch's ``Trace`` does; ``launch_us[i]``
    is the host time the event ``trace.events[i]`` was launched (None where
    no launch was recorded); ``spans`` are (name, start_us, end_us, id,
    parent id or None), in the order they opened.  Every time is in us on
    one clock."""

    trace: Trace
    launch_us: list
    spans: list


def capture_spans(step, sync, seconds: float, device, max_calls: int,
                  recorder) -> SpanTrace:
    """As :func:`trace.capture`, with ``recorder``'s spans on (the
    program's ``profiling`` module: ``enable``, ``disable``,
    ``take_spans``) and the launch time of each device event.  On the CPU
    an op's launch is its start."""
    on_card = torch.device(device).type == "cuda"
    act = (torch.profiler.ProfilerActivity.CUDA if on_card
           else torch.profiler.ProfilerActivity.CPU)
    recorder.take_spans()  # spans of before are not this stretch's
    with torch.profiler.profile(activities=[act]) as prof:
        recorder.enable()
        try:
            sync()
            c0 = time.perf_counter()
            calls = 0
            while calls < max_calls and (calls < 3 or
                                         time.perf_counter() - c0 < seconds):
                step()
                calls += 1
            sync()
        finally:
            recorder.disable()
    spans = recorder.take_spans()
    records = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in records), default=0)
    want = (torch.autograd.DeviceType.CUDA if on_card
            else torch.autograd.DeviceType.CPU)
    events, corr, launched = [], [], {}
    for e in records:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() != want:  # a host record: the launch's call
            c = e.correlation_id()
            launched[c] = min(launched.get(c, start), start)
            continue
        kind = kind_of(e.name())
        if kind is None or end <= start:
            continue
        events.append((e.name(), (start - t0) / 1e3, (end - t0) / 1e3,
                       kind))
        corr.append(e.correlation_id())
    if on_card:
        launch = [(launched[c] - t0) / 1e3 if c in launched else None
                  for c in corr]
    else:
        launch = [a for _, a, _, _ in events]
    span = (max(b for _, _, b, _ in events) - min(a for _, a, _, _ in events)
            if events else 0.0)
    return SpanTrace(Trace(events, span, calls), launch,
                     [(s.name, (s.start_ns - t0) / 1e3,
                       (s.end_ns - t0) / 1e3, s.id, s.parent)
                      for s in spans])


def _run_args(argv=None):
    """The run's ``--seed`` and ``--program`` (``portbench/run.py``'s
    command line; 0 and "port" where it has none)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--program", default="port")
    args, _ = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args.seed, args.program


def take(cell, seed: int, device) -> SpanTrace | None:
    """A stretch of ``cell``'s calls with the program's spans on: inputs
    from ``seed``, the mix prepared, warmed up, then profiled; taken again
    where a session has no device rows.  None where the program has no
    spans to turn on.  The garbage of the profiler sessions before it
    (reference cycles that only a full collection frees) is collected
    first: on an H100's host that collection took ~0.18 s, and inside the
    stretch it showed as device idle time under whatever span was open."""
    from radix_sort_tpu_torch.utils import profiling

    if not hasattr(profiling, "take_spans"):
        return None
    mix = cell.mix
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    inputs = mix.make_inputs(cell, seed, dev)
    state = mix.prepare(cell, inputs, dev)
    ev = torch.cuda.Event() if on_card else None

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def step():  # the window's closed loop: one call, then its answer
        mix.finish(cell, state, mix.call(cell, state))
        if on_card:
            ev.record()
            ev.synchronize()

    for _ in range(core.WARMUP_CALLS):
        step()
    sync()
    st = None
    for _ in range(core.PROFILE_SESSIONS):
        gc.collect()
        st = capture_spans(step, sync, core.PROFILE_S, dev,
                           core.PROFILE_MAX_CALLS, profiling)
        if st.trace.events:
            break
    return st


def stretch(run, seed: int | None = None, device=None) -> SpanTrace | None:
    """The stretch with spans on of ``run``, a traced run of the program,
    taken at the first call and kept on ``run.result``; None where the
    program recorded no span or the stretch no device event.  ``seed``
    and ``device`` default to the run's command line and its device."""
    res = run.result
    if not hasattr(res, "span_stretch"):
        st = None
        arg_seed, program = _run_args()
        if res.reading is not None and program == "port":
            if device is None:
                device = "cpu" if res.device_name == "cpu" else "cuda"
            st = take(run.cell, arg_seed if seed is None else seed, device)
        res.span_stretch = st
        if st is not None and st.spans and st.trace.events:
            first = res.reading.trace
            print("span_breakdown " + json.dumps(span_table(st, first)),
                  file=sys.stderr, flush=True)
    st = res.span_stretch
    return st if st is not None and st.spans and st.trace.events else None


def _innermost(spans):
    """The innermost open span over time: the sorted times at which it
    changes, and from each the index of that span in ``spans`` (None
    where none is open).  A span is open from its start, inclusive, to
    its end; at one time, a span that ends goes before one that starts,
    and of two that start the one opened first is the outer."""
    bounds = sorted([(s[1], 1, i) for i, s in enumerate(spans)] +
                    [(s[2], 0, i) for i, s in enumerate(spans)])
    open_, times, who = [], [], []
    for t, starts, i in bounds:
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
        top = open_[-1] if open_ else None
        if times and times[-1] == t:
            who[-1] = top
        else:
            times.append(t)
            who.append(top)
    return times, who


@dataclasses.dataclass
class Attribution:
    """Device and idle us of a stretch by the span they belong to:
    ``device_us[i]`` and ``idle_us[i]`` for ``spans[i]`` as the innermost
    span, and the caller's, outside every span (a device event with no
    launch record is the caller's too)."""

    device_us: list
    idle_us: list
    caller_device_us: float
    caller_idle_us: float


def attribute(st: SpanTrace) -> Attribution:
    times, who = _innermost(st.spans)

    def at(t):
        k = bisect.bisect_right(times, t) - 1
        return who[k] if k >= 0 else None

    dev = [0.0] * len(st.spans)
    idle = [0.0] * len(st.spans)
    caller_dev = caller_idle = 0.0
    for (_, a, b, _), t in zip(st.trace.events, st.launch_us):
        i = None if t is None else at(t)
        if i is None:
            caller_dev += b - a
        else:
            dev[i] += b - a
    ivals = [(a, b) for _, a, b, _ in st.trace.events]
    if ivals:
        lo, hi = min(a for a, _ in ivals), max(b for _, b in ivals)
        for a, b, _ in window.gaps(ivals, lo, hi):
            k = bisect.bisect_right(times, a) - 1
            t = a
            while t < b:
                end = min(b, times[k + 1]) if k + 1 < len(times) else b
                i = who[k] if k >= 0 else None
                if i is None:
                    caller_idle += end - t
                else:
                    idle[i] += end - t
                t, k = end, k + 1
    return Attribution(dev, idle, caller_dev, caller_idle)


def _ancestry(spans):
    """For each span, the names of it and every span it lies in."""
    index = {s[3]: i for i, s in enumerate(spans)}
    names = []
    for s in spans:
        chain, p = {s[0]}, s[4]
        while p is not None and p in index:
            q = spans[index[p]]
            chain.add(q[0])
            p = q[4]
        names.append(chain)
    return names


def device_ms_under(st: SpanTrace, name: str) -> float | None:
    """Device ms a call of the events launched under a span ``name``: in
    it or in any span below it.  None where no span has that name."""
    if not any(s[0] == name for s in st.spans):
        return None
    att = attribute(st)
    us = sum(d for d, chain in zip(att.device_us, _ancestry(st.spans))
             if name in chain)
    return us / 1e3 / st.trace.calls


def device_ms_in(st: SpanTrace, names) -> float | None:
    """Device ms a call of the events whose innermost span is one of
    ``names``.  None where no span has one of those names."""
    if not any(s[0] in names for s in st.spans):
        return None
    att = attribute(st)
    us = sum(d for d, s in zip(att.device_us, st.spans) if s[0] in names)
    return us / 1e3 / st.trace.calls


def span_table(st: SpanTrace, first: Trace | None = None) -> dict:
    """The stretch's ``span_breakdown``: device ms and idle ms a call by
    span name (the span as the innermost one), the caller's, the share of
    device-busy time the spans account for, and the stretch's busy ms a
    call and idle share beside the first stretch's (spans off)."""
    att = attribute(st)
    calls = st.trace.calls
    by = {}
    for s, d, i in zip(st.spans, att.device_us, att.idle_us):
        row = by.setdefault(s[0], [0.0, 0.0])
        row[0] += d
        row[1] += i
    busy = st.trace.busy_us()
    in_spans = sum(att.device_us)

    def ms(us):
        return us / 1e3 / calls

    def stretch_of(t):
        return {"calls": t.calls, "busy_ms": t.busy_us() / 1e3 / t.calls,
                "idle_share": 100.0 * t.idle_share()}

    out = {**stretch_of(st.trace),
           "span_device_share": 100.0 * in_spans / busy if busy else None,
           "unlaunched_events": sum(t is None for t in st.launch_us),
           "spans": {n: {"device_ms": ms(d), "idle_ms": ms(i)}
                     for n, (d, i) in sorted(by.items(),
                                             key=lambda x: -x[1][0])},
           "caller": {"device_ms": ms(att.caller_device_us),
                      "idle_ms": ms(att.caller_idle_us)}}
    if first is not None and first.events:
        out["first_stretch"] = stretch_of(first)
    return out
