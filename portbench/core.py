"""One run of one cell on one card: set-up, the window, the traced
stretch and the check against the plain reference.

The window is a closed loop of one caller: a call is issued when the one
before it has ended.  A call is the mix's ``call`` (the program's entry)
and ``finish`` (what a user does to get the answer: nothing for a sort,
whose end is the synchronise below; the result table brought to the host
for a query); the harness then records a CUDA event and waits for it, so
each call's latency is the device clock from its start to its answer,
host work included (a time of a few ms on the host clock would be off by
its jitter).  Rates and set-up are host-clock times of seconds.

A traced run (``trace``) drives the same window and profiles one stretch
of it (``PROFILE_S`` seconds from its middle); the calls outside the
stretch give the host-clock enqueue times and the program's counters.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from . import trace as trace_lib
from .gen import seeds

PROFILE_S = 1.0            # host seconds of the profiled stretch
PROFILE_MAX_CALLS = 20000  # bounds the profiler's records
PROFILE_SESSIONS = 3       # a session with no device rows is taken again
WARMUP_CALLS = 2


@dataclasses.dataclass
class Reading:
    """What the per-layer readers see of a traced run."""

    trace: trace_lib.Trace | None
    enqueue_ms: list      # host ms from a call's start to the entry's return
    counters: dict        # growth of the program's counters a call
    device_name: str


@dataclasses.dataclass
class Result:
    ready_s: float        # wall seconds from the run's start to the window
    calls: int
    window_s: float
    latencies_ms: list
    peak_bytes: int       # the program's, without the answer kept for the check
    device_name: str
    checks: dict          # name -> the number compared with its limit
    answers: int          # answers compared
    wrong: int            # answers over a limit
    reading: Reading | None = None


def held_bytes(answer) -> int:
    """Device bytes of the storage behind an answer's tensors."""
    seen = {}
    for v in (answer or {}).values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            st = v.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def drive(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, program: str = "port") -> Result:
    """Run ``cell`` once: inputs from ``seed``, warm-up, a window of
    ``seconds``, then the check.  ``program`` is "port" (the system under
    test) or "control" (the reference's control in its place).
    ``t_start`` is the wall time the run began."""
    mix, ref = cell.mix, cell.reference
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    inputs = mix.make_inputs(cell, seed, dev)
    if program == "port":
        state = mix.prepare(cell, inputs, dev)

        def entry():
            return mix.call(cell, state)

        def finish(raw):
            return mix.finish(cell, state, raw)
    elif program == "control":
        def entry():
            return ref.control(cell, inputs)

        def finish(raw):
            return raw
    else:
        raise ValueError(f"unknown program {program!r}")

    ev0 = torch.cuda.Event(enable_timing=True) if on_card else None
    ev1 = torch.cuda.Event(enable_timing=True) if on_card else None

    def timed_call():
        if on_card:
            ev0.record()
        h0 = time.perf_counter()
        raw = entry()
        h1 = time.perf_counter()
        ans = finish(raw)
        if on_card:
            ev1.record()
            ev1.synchronize()
            lat = ev0.elapsed_time(ev1)
        else:
            lat = (time.perf_counter() - h0) * 1e3
        return ans, lat, (h1 - h0) * 1e3

    def step():
        timed_call()

    for _ in range(WARMUP_CALLS):
        timed_call()
    sync()
    if trace:  # the profiler's own start-up, outside the window
        trace_lib.capture(step, sync, 0.0, dev, max_calls=1, min_calls=1)
    ready_s = time.time() - t_start

    # KEEP_ALL mixes answer with a few host rows and keep every answer;
    # the others keep the last answer and one drawn from the seed
    # (reservoir sampling).  The drawn one outlives the calls after it, so
    # its device bytes (``held``) are taken off the peak: the peak is the
    # program's, over the caller's inputs and the call's own answer.
    keep_all = getattr(mix, "KEEP_ALL", False)
    rng = random.Random(seeds.stream(seed, "sample"))
    kept, sample, last = [], None, None
    held = peak = 0
    lat_ms, enq_ms = [], []
    counted_calls, grown = 0, {}
    prof = None

    def peak_so_far():
        return torch.cuda.max_memory_allocated(dev) - held if on_card else 0

    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    sync()
    t0 = time.perf_counter()
    before = mix.counters()
    calls = 0
    ans = None
    while True:
        e = time.perf_counter() - t0
        if e >= seconds:
            break
        ans = last = None  # only the sample outlives its call
        if trace and prof is None and e >= seconds / 2:
            now = mix.counters()
            for k, v in now.items():
                grown[k] = grown.get(k, 0) + v - before[k]
            prof = trace_lib.capture(step, sync, PROFILE_S, dev,
                                     PROFILE_MAX_CALLS)
            calls += prof.calls
            before = mix.counters()
            continue
        ans, lat, enq = timed_call()
        calls += 1
        counted_calls += 1
        lat_ms.append(lat)
        enq_ms.append(enq)
        if keep_all:
            kept.append(ans)
        else:
            last = ans
            if rng.random() * counted_calls < 1.0:
                peak = max(peak, peak_so_far())
                sample = ans  # the one drawn before is freed here
                if on_card:
                    torch.cuda.reset_peak_memory_stats(dev)
                held = held_bytes(sample)
    window_s = time.perf_counter() - t0
    for k, v in mix.counters().items():
        grown[k] = grown.get(k, 0) + v - before[k]
    peak = max(peak, peak_so_far())

    reading = None
    if trace:
        for _ in range(PROFILE_SESSIONS - 1):
            if prof is not None and prof.events:
                break
            prof = trace_lib.capture(step, sync, PROFILE_S, dev,
                                     PROFILE_MAX_CALLS)
        reading = Reading(prof, enq_ms,
                          {k: v / max(counted_calls, 1)
                           for k, v in grown.items()}, _device_name(dev))

    if not keep_all:
        kept = [sample] if last is None or last is sample else [sample,
                                                                last]
    # the program's state goes before the reference runs, so the reference
    # neither sets the peak nor runs short of memory
    del entry, finish, step, timed_call
    if program == "port":
        del state
    sample = last = None
    if on_card:
        torch.cuda.empty_cache()
    expected = ref.expected(cell, inputs)
    checks, wrong = {}, 0
    for ans in kept:
        got = ref.compare(cell, inputs, expected, ans)
        wrong += any(v > ref.LIMITS[k] for k, v in got.items())
        for k, v in got.items():
            checks[k] = max(checks.get(k, v), v)
    return Result(ready_s, calls, window_s, lat_ms, peak, _device_name(dev),
                  checks, len(kept), wrong, reading)
