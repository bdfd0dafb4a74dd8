"""TPC-H Q3, the shipping-priority query, through the program's ``Query``
layer:

    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = SEGMENT and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < DATE
      and l_shipdate > DATE
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate
    limit LIMIT

over the configuration's ``customer``, ``orders`` and ``lineitem``
(``gen/tpch_orders.py``), made once on the card from the seed.  A call is
three ``Query`` chains a user writes: the customers of the segment; the
orders before DATE joined with them on ``custkey``; the line items
shipped after DATE joined with those orders on ``orderkey``, the revenue
a derived int64 column (1e-4 units), grouped by the order key with the
order's date and priority as ``min`` (both are functions of the key),
sorted by revenue descending then date, the first LIMIT rows.  Each join
key carries one name on both sides (``c_custkey`` and ``o_custkey`` are
``custkey``, ``o_orderkey`` and ``l_orderkey`` ``orderkey``), and each
join has ``max_duplicates=1``: the build keys are unique.  The group-by
emits keys in ascending order and ``sort_by`` is stable, so ties in
revenue and date go to the smaller order key.  ``finish`` brings the
result and both joins' statistics to the host, as a user reads them.
Traffic parameters: ``segment``, ``date`` (ISO), ``limit``."""

from __future__ import annotations

import numpy as np
import torch

import radix_sort_tpu_torch as rt
from portbench.gen import tpch_orders
from radix_sort_tpu_torch.ops import join as join_ops

KEEP_ALL = True  # answers are a few host rows: every call is compared
SHARED_KEYS = {"c_custkey": "custkey", "o_custkey": "custkey",
               "o_orderkey": "orderkey", "l_orderkey": "orderkey"}


def rows_per_call(cell) -> int:
    c = cell.config
    return c["customer_rows"] + c["orders_rows"] + c["lineitem_rows"]


def date_days(cell) -> int:
    return int(np.datetime64(cell.traffic["date"], "D").astype(np.int64))


def make_inputs(cell, seed, device) -> dict:
    return tpch_orders.tables(cell.config, seed, device)


def prepare(cell, inputs, device) -> dict:
    return {name: rt.Table({SHARED_KEYS.get(k, k): v for k, v in t.items()})
            for name, t in inputs.items()}


def call(cell, state):
    date = date_days(cell)
    segment = tpch_orders.SEGMENTS.index(cell.traffic["segment"])
    cust = (rt.Query(state["customer"])
            .filter("c_mktsegment", "eq", segment)
            .select("custkey")
            .collect())
    orders = (rt.Query(state["orders"])
              .filter("o_orderdate", "lt", date)
              .join(cust, on="custkey", max_duplicates=1)
              .select("orderkey", "o_orderdate", "o_shippriority"))
    ords = orders.collect()
    lines = (rt.Query(state["lineitem"])
             .filter("l_shipdate", "gt", date)
             .select("orderkey", "l_extendedprice", "l_discount")
             .join(ords, on="orderkey", max_duplicates=1)
             .with_column("rev", lambda t: t["l_extendedprice"]
                          * (100 - t["l_discount"]))
             .group_by("orderkey", revenue=("sum", "rev"),
                       o_orderdate=("min", "o_orderdate"),
                       o_shippriority=("min", "o_shippriority"))
             .sort_by("revenue", "o_orderdate", descending=(True, False))
             .limit(cell.traffic["limit"]))
    out = lines.collect()
    return out, (orders.last_stats["join"], lines.last_stats["join"])


def finish(cell, table, result) -> dict:
    out, stats = result
    rows = out.to_numpy()
    joins = torch.stack([torch.stack([s["match_count"].to(torch.int64),
                                      s["overflow"].to(torch.int64)])
                         for s in stats]).cpu().numpy()
    return {"l_orderkey": rows["orderkey"], "revenue": rows["revenue"],
            "o_orderdate": rows["o_orderdate"],
            "o_shippriority": rows["o_shippriority"],
            "join_match_count": joins[:, 0],
            "join_overflow": joins[:, 1].astype(bool)}


def counters() -> dict:
    """Rows that entered the joins' sorts, where the program counts them."""
    if not hasattr(join_ops, "sorted_rows"):
        return {}
    return {"join_sorted_rows": join_ops.sorted_rows}
