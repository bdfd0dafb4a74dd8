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

On several cards (``ranks``, from ``launch.py``) every rank runs this in
lockstep: before each call rank 0's decision (call, profile or stop) is
broadcast on the harness's gloo group, outside the timed interval; each
rank times its calls as one card does; after the window a call's latency
is the slowest rank's, the peak the fullest card's, and every rank's
profiled stretch is gathered: the readers of the device trace read the
rank with the most device time a call outside NCCL's kernels (the hot
rank, the one the others wait for).  The window's
host seconds and the counters are rank 0's.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import time

import torch

from . import trace as trace_lib
from .gen import seeds

PROFILE_S = 1.0            # host seconds of the profiled stretch
PROFILE_MAX_CALLS = 20000  # bounds the profiler's records
PROFILE_SESSIONS = 3       # a session with no device rows is taken again
WARMUP_CALLS = 2
CALL, PROFILE, STOP = 0, 1, 2  # what the window does next


@dataclasses.dataclass
class Reading:
    """What the per-layer readers see of a traced run."""

    trace: trace_lib.Trace | None
    enqueue_ms: list      # host ms from a call's start to the entry's return
    counters: dict        # growth of the program's counters a call
    device_name: str
    rank_traces: list | None = None  # every rank's stretch, several cards
    hot_rank: int | None = None      # whose stretch ``trace`` is


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
    rank_peak_bytes: list | None = None  # each rank's, several cards


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


def hot_rank(traces: list) -> int:
    """The rank whose stretch had the most device time a call outside
    NCCL's kernels (``Trace.work_us``)."""
    return max(range(len(traces)),
               key=lambda r: traces[r].work_us() / traces[r].calls)


def drive(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float, program: str = "port", ranks=None) -> Result:
    """Run ``cell`` once: inputs from ``seed``, warm-up, a window of
    ``seconds``, then the check.  ``program`` is "port" (the system under
    test) or "control" (the reference's control in its place).
    ``t_start`` is the wall time the run began.  ``ranks``
    (``launch.Ranks``) makes this one rank of a run on several cards."""
    mix, ref = cell.mix, cell.reference
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def agreed(value):
        """Rank 0's ``value`` on every rank; on one card the value."""
        return value if ranks is None else ranks.flag(value)

    def everywhere(ok: bool) -> bool:
        return ok if ranks is None else all(ranks.gather(bool(ok)))

    def capture(seconds_, max_calls, min_calls=3):
        return trace_lib.capture(step, sync, seconds_, dev, max_calls,
                                 min_calls, agree=agreed)

    if ranks is None:
        inputs = mix.make_inputs(cell, seed, dev)
    else:
        inputs = mix.make_inputs(cell, seed, dev, ranks)
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

    # On several cards each warm-up call's answer is kept through the
    # next, as the window keeps its drawn answer through the calls after
    # it: the allocator's cache is then shaped for the window's calls, and
    # the window's first calls allocate no new device memory.  A rank's
    # start-up objects are collected and frozen before the warm-ups: no
    # collection in the window scans them, and the window starts right
    # after a warm call, not after an idle card's collection.
    if ranks is not None:
        gc.collect()
        gc.freeze()
    warm = None
    for _ in range(WARMUP_CALLS):
        if ranks is None:
            timed_call()
        else:
            warm = timed_call()[0]
    warm = None
    sync()
    if trace:  # the profiler's own start-up, outside the window
        capture(0.0, max_calls=1, min_calls=1)
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
        nxt = agreed(STOP if e >= seconds else
                     PROFILE if trace and prof is None and e >= seconds / 2
                     else CALL)
        if nxt == STOP:
            break
        ans = last = None  # only the sample outlives its call
        if nxt == PROFILE:
            now = mix.counters()
            for k, v in now.items():
                grown[k] = grown.get(k, 0) + v - before[k]
            prof = capture(PROFILE_S, PROFILE_MAX_CALLS)
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

    rank_peaks = None
    if ranks is not None:  # a call ends when its slowest rank's ends
        lat_ms = [max(c) for c in zip(*ranks.gather(lat_ms))]
        rank_peaks = ranks.gather(peak)
        peak = max(rank_peaks)

    reading = None
    if trace:
        for _ in range(PROFILE_SESSIONS - 1):
            if everywhere(prof is not None and bool(prof.events)):
                break
            prof = capture(PROFILE_S, PROFILE_MAX_CALLS)
        reading = Reading(prof, enq_ms,
                          {k: v / max(counted_calls, 1)
                           for k, v in grown.items()}, _device_name(dev))
        if ranks is not None:
            traces = ranks.gather(prof)
            if all(t.events for t in traces):
                hot = hot_rank(traces)
                reading.trace, reading.hot_rank = traces[hot], hot
                reading.rank_traces = traces

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
                  checks, len(kept), wrong, reading, rank_peaks)
