"""TPC-H Q3 (clause 2.4.3) in plain PyTorch, independent of the port:

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
(the build keys are unique); the groups by ``torch.unique``, the revenue
an ``index_add_`` (exact in int64: 1e-4 units, the product of two
hundredths), the order's date and priority by ``scatter_reduce("amin")``
(both are functions of the order key); the order by two stable sorts, so
that ties in revenue go to the earlier ``o_orderdate``, then to the
smaller ``l_orderkey``.  The benchmark keeps a frozen copy of this query
in ``portbench/reference/tpch_q3.py``."""

from __future__ import annotations

import torch


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
