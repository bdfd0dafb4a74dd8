"""The plain reference of TPC-H Q3, in plain PyTorch.

From the same ``customer``, ``orders`` and ``lineitem`` columns the
benchmark handed the program (``gen/tpch_orders.py``, TPC-H names):

    select l_orderkey, sum(l_extendedprice * (1 - l_discount)) as revenue,
           o_orderdate, o_shippriority
    from customer, orders, lineitem
    where c_mktsegment = SEGMENT and c_custkey = o_custkey
      and l_orderkey = o_orderkey and o_orderdate < DATE
      and l_shipdate > DATE
    group by l_orderkey, o_orderdate, o_shippriority
    order by revenue desc, o_orderdate
    limit LIMIT

Boolean masks for the filters; each join by a dense table indexed by key
(the build keys are unique), independent of the program's sort-merge
join; the groups by ``torch.unique``, the revenue an exact int64
``index_add_`` (1e-4 units), the order's date and priority by
``scatter_reduce("amin")``; the order by two stable sorts, so that ties in
revenue go to the earlier ``o_orderdate``, then to the smaller
``l_orderkey``.  A frozen copy of ``tests/tpch_q3_reference.py``'s query.

``compare`` counts, every limit 0 (the answer is exact): ``rows_wrong``,
the answer's rows whose (l_orderkey, o_orderdate, o_shippriority)
differ, a missing or extra row counting as one; ``revenue_wrong``, the
same for the revenue; ``join_rows_wrong``, the joins whose match count
differs from the reference's joined rows; ``overflow``, the joins that
raised their flag.

The control is the same query with the revenue summed in float32 (the
step a later change would be tempted by): an order's revenue reaches
~7e9 units, where float32 keeps multiples of 512."""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"rows_wrong": 0, "revenue_wrong": 0, "join_rows_wrong": 0,
          "overflow": 0}
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
            "HOUSEHOLD")
ROW = ("l_orderkey", "o_orderdate", "o_shippriority")


def segment_code(cell) -> int:
    return SEGMENTS.index(cell.traffic["segment"])


def date_days(cell) -> int:
    """The traffic's DATE in days since 1970-01-01."""
    return int(np.datetime64(cell.traffic["date"], "D").astype(np.int64))


def q3(customer: dict, orders: dict, lineitem: dict, segment: int,
       date: int, limit: int | None = None,
       revenue_dtype: torch.dtype = torch.int64) -> dict:
    """The answer's rows (``l_orderkey``, ``revenue`` as int64 1e-4 units,
    ``o_orderdate``, ``o_shippriority``) and ``join_rows``, the rows of
    orders ⋈ customer and of lineitem ⋈ that join, from column dicts of
    TPC-H names; ``revenue_dtype`` is the type the sums are taken in."""
    c_key, o_cust = customer["c_custkey"], orders["o_custkey"]
    dev = o_cust.device
    size = int(torch.maximum(c_key.max(), o_cust.max())) + 1
    in_segment = torch.zeros(size, dtype=torch.bool, device=dev)
    in_segment[c_key[customer["c_mktsegment"] == segment]] = True
    o_keep = (orders["o_orderdate"] < date) & in_segment[o_cust]
    o_key = orders["o_orderkey"][o_keep]

    l_key_all = lineitem["l_orderkey"]
    size = int(torch.maximum(orders["o_orderkey"].max(),
                             l_key_all.max())) + 1
    order_row = torch.full((size,), -1, dtype=torch.int64, device=dev)
    order_row[o_key] = torch.arange(o_key.shape[0], device=dev)
    l_keep = lineitem["l_shipdate"] > date
    row = order_row[l_key_all[l_keep]]
    hit = row >= 0
    row = row[hit]
    l_key = l_key_all[l_keep][hit]
    rev = (lineitem["l_extendedprice"][l_keep][hit]
           * (100 - lineitem["l_discount"][l_keep][hit]))

    keys, inv = torch.unique(l_key, sorted=True, return_inverse=True)
    g = keys.shape[0]
    revenue = torch.zeros(g, dtype=revenue_dtype, device=dev).index_add_(
        0, inv, rev.to(revenue_dtype))

    def order_min(col):
        v = orders[col][o_keep][row]
        return torch.full((g,), torch.iinfo(v.dtype).max, dtype=v.dtype,
                          device=dev).scatter_reduce_(0, inv, v, "amin")

    o_date, o_prio = order_min("o_orderdate"), order_min("o_shippriority")
    by = torch.sort(o_date, stable=True).indices
    by = by[torch.sort(revenue[by], descending=True, stable=True).indices]
    if limit is not None:
        by = by[:limit]
    if revenue.is_floating_point():
        revenue = torch.round(revenue)
    return {"l_orderkey": keys[by], "revenue": revenue[by].to(torch.int64),
            "o_orderdate": o_date[by], "o_shippriority": o_prio[by],
            "join_rows": torch.tensor([o_key.shape[0], l_key.shape[0]],
                                      dtype=torch.int64)}


def _query(cell, inputs, revenue_dtype) -> dict:
    out = q3(inputs["customer"], inputs["orders"], inputs["lineitem"],
             segment_code(cell), date_days(cell), cell.traffic["limit"],
             revenue_dtype)
    return {k: v.cpu().numpy() for k, v in out.items()}


def expected(cell, inputs: dict) -> dict:
    return _query(cell, inputs, torch.int64)


def compare(cell, inputs: dict, expected: dict, answer: dict) -> dict:
    e = expected["l_orderkey"].shape[0]

    def wrong(names):
        cols = [np.asarray(answer.get(n, [])) for n in names]
        a = min(c.shape[0] for c in cols)
        m = min(a, e)
        differ = np.zeros(m, dtype=bool)
        for n, c in zip(names, cols):
            differ |= c[:m].astype(np.int64) != expected[n][:m]
        return int(differ.sum()) + abs(a - e)

    joins = np.asarray(answer.get("join_match_count", []), dtype=np.int64)
    flags = np.asarray(answer.get("join_overflow", [True, True]))
    return {"rows_wrong": wrong(ROW), "revenue_wrong": wrong(("revenue",)),
            "join_rows_wrong": (int((joins != expected["join_rows"]).sum())
                                if joins.shape == (2,) else 2),
            "overflow": int(flags.astype(bool).sum())}


def control(cell, inputs: dict) -> dict:
    out = _query(cell, inputs, torch.float32)
    out["join_match_count"] = out.pop("join_rows")
    out["join_overflow"] = np.zeros(2, dtype=bool)
    return out
