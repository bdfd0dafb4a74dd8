"""The window's arithmetic against hand-worked cases and numpy."""

import statistics

import numpy as np
import pytest

from portbench import window


def test_rate_is_all_work_over_all_time():
    assert window.rate(3000, 1.5) == 2000.0
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101, 1000])
def test_percentile_matches_numpy_linear(n):
    rng = np.random.default_rng(n)
    xs = rng.exponential(size=n).tolist()
    for q in (50, 95, 99):
        assert window.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)


def test_p95_counts_every_call():
    # 100 calls, 5 slow ones: the 95th percentile sits between them
    xs = [1.0] * 95 + [10.0] * 5
    assert window.percentile(xs, 95) == pytest.approx(1.0 + 9.0 * 0.05)


def test_spread_is_iqr_over_median_as_statistics_gives_it():
    xs = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert window.spread(xs) == pytest.approx((q3 - q1) / med)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 2), (1, 3)], 3.0),          # overlap counted once
    ([(0, 10), (2, 3), (4, 5)], 10.0),  # nested
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),  # unsorted
])
def test_union_length(intervals, busy):
    assert window.union_length(intervals) == pytest.approx(busy)


def test_gaps_name_the_interval_that_ends_them():
    ivals = [(1, 2), (4, 5), (4.5, 7)]
    got = window.gaps(ivals, 0, 10)
    assert got == [(0, 1, 0), (2, 4, 1), (7, 10, None)]
    busy = window.union_length(ivals)  # 1 + 3 of the 10 units
    assert busy == pytest.approx(4)
    assert sum(b - a for a, b, _ in got) == pytest.approx(10 - busy)


def test_sort_bytes_and_roofline():
    # 2^27 u32 keys + int32 payload: one read and one write of 8 B a row
    n = 1 << 27
    assert window.sort_bytes(n, 4, 4) == 2 * n * 8
    # at exactly the bandwidth the share is 100%
    assert window.roofline_share(3.35e12, 1.0, 3.35e12) == pytest.approx(100)
    assert window.roofline_share(2.147e9, 5.70e-3, 3.35e12) == \
        pytest.approx(11.24, abs=0.01)
