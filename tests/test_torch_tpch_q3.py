"""TPC-H Q3 on the port: the benchmark's generator of ``customer``,
``orders`` and ``lineitem`` (``portbench/gen/tpch_orders.py``) keeps
dbgen's rules; the ``Query`` chain that the ``q3-sf10`` cell times
(``portbench/mixes/tpch_q3.py``: a filter, two ``join``s, ``with_column``,
``group_by``, ``sort_by``, ``limit``) gives the plain reference's answer
(``tpch_q3_reference.py``), every group, the top rows, both joins' row
counts and the tie rule; the float32 control fails the benchmark's
check; and the benchmark's frozen copy of the reference agrees with this
one."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import tpch_q3_reference as ref  # noqa: E402
from portbench import spec  # noqa: E402
from portbench.gen import tpch_orders  # noqa: E402

CPU = torch.device("cpu")
BUILDING, DATE = 1, 9204  # the traffic's segment and 1995-03-15
SEEDS = [7, 2**33 + 5]


def _small(sf=0.002, limit=None):
    """The q3-sf10 cell at scale factor ``sf`` (dbgen's rows per SF, the
    line total 4 a order less 0.02%); ``limit`` replaces the traffic's."""
    cell = spec.cell("q3-sf10")
    orders = round(sf * 1_500_000)
    cell.config.update(scale_factor=sf, customer_rows=round(sf * 150_000),
                       orders_rows=orders,
                       lineitem_rows=4 * orders - orders // 5000 - 1)
    if limit is not None:
        cell.traffic["limit"] = limit
    return cell


def _run(cell, inputs):
    mix = cell.mix
    state = mix.prepare(cell, inputs, CPU)
    return mix.finish(cell, state, mix.call(cell, state))


def _reference(cell, inputs, limit, revenue_dtype=torch.int64):
    out = ref.q3(inputs["customer"], inputs["orders"], inputs["lineitem"],
                 BUILDING, DATE, limit, revenue_dtype)
    return {k: v.numpy() for k, v in out.items()}


def _assert_rows_equal(got, want):
    for k in ("l_orderkey", "revenue", "o_orderdate", "o_shippriority"):
        assert np.array_equal(got[k].astype(np.int64),
                              want[k].astype(np.int64)), k


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_keeps_dbgen_rules(seed):
    cell = _small(0.001)
    c = cell.config
    t = tpch_orders.tables(c, seed, CPU)
    cust, ords, li = t["customer"], t["orders"], t["lineitem"]
    assert torch.equal(cust["c_custkey"], torch.arange(1, 151))
    assert cust["c_mktsegment"].dtype == torch.uint8
    assert set(cust["c_mktsegment"].tolist()) == set(range(5))
    i = torch.arange(c["orders_rows"])
    assert torch.equal(ords["o_orderkey"], (i // 8) * 32 + i % 8 + 1)
    assert torch.equal(tpch_orders.orderkeys(15_000_000, CPU)[-1:],
                       torch.tensor([59_999_976]))
    oc = ords["o_custkey"]
    assert (oc % 3 != 0).all() and oc.min() >= 1 and oc.max() <= 150
    od = ords["o_orderdate"]
    assert od.dtype == torch.int32 and od.min() >= 8035 and od.max() <= 10440
    assert not ords["o_shippriority"].any()
    assert li["l_orderkey"].shape[0] == c["lineitem_rows"]
    keys, per = torch.unique_consecutive(li["l_orderkey"],
                                         return_counts=True)
    assert torch.equal(keys, ords["o_orderkey"])  # every order, in order
    assert per.min() >= 1 and per.max() <= 7
    order = torch.repeat_interleave(per)
    lag = li["l_shipdate"].to(torch.int64) - od[order]
    assert lag.min() >= 1 and lag.max() <= 121
    assert li["l_shipdate"].dtype == torch.int32
    d = li["l_discount"]
    assert d.min() >= 0 and d.max() <= 10
    p = li["l_extendedprice"]
    assert p.min() >= 90_000 and p.max() <= 50 * (90_000 + 20_000 + 99_900)
    again = tpch_orders.tables(c, seed, CPU)
    assert all(torch.equal(again[n][k], v)
               for n in t for k, v in t[n].items())


@pytest.mark.parametrize("total", [1000, 1001, 3997, 4003, 6999, 7000])
def test_line_counts_are_held_to_the_total(total):
    per = tpch_orders.lines_per_order(1000, total, 11, CPU)
    assert int(per.sum()) == total
    assert per.min() >= 1 and per.max() <= 7
    with pytest.raises(ValueError):
        tpch_orders.lines_per_order(1000, 7001, 11, CPU)


@pytest.mark.parametrize("seed", SEEDS)
def test_query_chain_gives_every_group(seed):
    cell = _small(0.005, limit=10**9)
    inputs = cell.mix.make_inputs(cell, seed, CPU)
    got = _run(cell, inputs)
    want = _reference(cell, inputs, None)
    assert len(want["l_orderkey"]) > 30
    _assert_rows_equal(got, want)
    assert np.array_equal(got["join_match_count"], want["join_rows"])
    assert not got["join_overflow"].any()


@pytest.mark.parametrize("seed", SEEDS)
def test_query_chain_top_10_and_join_counts(seed):
    cell = _small(0.005)
    inputs = cell.mix.make_inputs(cell, seed, CPU)
    got = _run(cell, inputs)
    want = _reference(cell, inputs, 10)
    assert len(got["l_orderkey"]) == 10
    _assert_rows_equal(got, want)
    bench = cell.reference
    assert bench.compare(cell, inputs, bench.expected(cell, inputs),
                         got) == {k: 0 for k in bench.LIMITS}


def _tied_tables():
    """Five orders of segment BUILDING before DATE, each of one line
    shipped after it: order 5 is alone at the top; 3 and 4 tie on
    revenue and date; 1 and 2 tie on revenue, 2 the earlier.  Customer 2
    is of another segment, and its order 6 matches no customer of the
    filter."""
    orders = {"o_orderkey": torch.tensor([1, 2, 3, 4, 5, 6]),
              "o_custkey": torch.tensor([1, 1, 4, 4, 5, 2]),
              "o_orderdate": torch.tensor([9100, 9000, 9050, 9050, 9200,
                                           9100], dtype=torch.int32),
              "o_shippriority": torch.zeros(6, dtype=torch.int32)}
    price = torch.tensor([200_000, 200_000, 100_000, 100_000, 900_000,
                          500_000])
    return {"customer": {"c_custkey": torch.tensor([1, 2, 4, 5]),
                         "c_mktsegment": torch.tensor([1, 0, 1, 1],
                                                      dtype=torch.uint8)},
            "orders": orders,
            "lineitem": {"l_orderkey": torch.tensor([4, 3, 2, 1, 5, 6]),
                         "l_extendedprice": price,
                         "l_discount": torch.zeros(6, dtype=torch.int64),
                         "l_shipdate": torch.full((6,), 9300,
                                                  dtype=torch.int32)}}


def test_ties_go_to_the_earlier_date_then_the_smaller_key():
    cell = _small(limit=10)
    inputs = _tied_tables()
    got = _run(cell, inputs)
    assert got["l_orderkey"].tolist() == [5, 3, 4, 2, 1]
    assert got["revenue"].tolist() == [90_000_000, 20_000_000, 20_000_000,
                                       10_000_000, 10_000_000]
    assert got["join_match_count"].tolist() == [5, 5]
    _assert_rows_equal(got, _reference(cell, inputs, 10))


def test_float32_control_fails_the_check():
    cell = _small(0.005)
    inputs = cell.mix.make_inputs(cell, SEEDS[1], CPU)
    bench = cell.reference
    got = bench.compare(cell, inputs, bench.expected(cell, inputs),
                        bench.control(cell, inputs))
    assert got["revenue_wrong"] > bench.LIMITS["revenue_wrong"]


@pytest.mark.parametrize("revenue_dtype", [torch.int64, torch.float32])
def test_benchmark_reference_is_this_reference(revenue_dtype):
    cell = _small(0.005)
    inputs = cell.mix.make_inputs(cell, SEEDS[0], CPU)
    bench = cell.reference
    assert (bench.segment_code(cell), bench.date_days(cell)) == (BUILDING,
                                                                 DATE)
    frozen = bench._query(cell, inputs, revenue_dtype)
    want = _reference(cell, inputs, 10, revenue_dtype)
    assert set(frozen) == set(want)
    for k, v in want.items():
        assert np.array_equal(frozen[k], v), k
