"""The window's arithmetic: rates, percentiles, spreads, busy time and the
roofline.  Plain Python over plain numbers, so the CPU tests hold it
against hand-worked cases."""

from __future__ import annotations

import math
import statistics


def rate(units: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return units / seconds


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    linearly between the two nearest ranks (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median, quartiles as ``statistics.quantiles(values, n=4)`` gives
    them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals: the time in which at
    least one of them ran."""
    total, reach = 0.0, -math.inf
    for start, end in sorted(intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def gaps(intervals, start: float, end: float):
    """The idle stretches of [start, end] that no interval covers, as
    (gap start, gap end, index of the interval that ends the gap or None
    for the tail), in time order."""
    out, reach = [], start
    order = sorted(range(len(intervals)), key=lambda i: intervals[i])
    for i in order:
        a, b = intervals[i]
        if a > reach:
            out.append((reach, min(a, end), i))
        reach = max(reach, b)
    if reach < end:
        out.append((reach, end, None))
    return [g for g in out if g[1] > g[0]]


def sort_bytes(n: int, key_bytes: int, payload_bytes: int) -> int:
    """The least traffic of any sort of ``n`` rows: one read and one write
    of every key and payload byte, whatever implements it."""
    return 2 * n * (key_bytes + payload_bytes)


def roofline_share(bytes_moved: float, seconds: float,
                   bytes_per_s: float) -> float:
    """Percent of the memory roofline: the least time the bytes take at
    the peak bandwidth over the time they took."""
    if seconds <= 0:
        raise ValueError("no device time")
    return 100.0 * bytes_moved / bytes_per_s / seconds
