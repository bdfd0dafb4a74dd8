"""TPC-H Q1 through the program's ``Query`` layer.

    select l_returnflag, l_linestatus, sum(l_quantity),
      sum(l_extendedprice), sum(l_extendedprice * (1 - l_discount)),
      sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
      avg(l_quantity), avg(l_extendedprice), avg(l_discount), count(*)
    from lineitem where l_shipdate <= date '1998-12-01' - interval 'DELTA'
    day group by l_returnflag, l_linestatus
    order by l_returnflag, l_linestatus

over the configuration's ``lineitem`` (``gen/tpch.py``), made once on the
card from the seed.  Decimals are int64 hundredths, so the products are
exact int64 (``disc_price`` in 1e-4, ``charge`` in 1e-6 units); the
group key is ``l_returnflag * 256 + l_linestatus`` (int16).  A call
collects the query and brings its result table to the host, as a user
reads it.  Traffic parameter: ``delta_days``."""

from __future__ import annotations

import torch

import radix_sort_tpu_torch as rt
from portbench.gen import tpch

KEEP_ALL = True  # answers are a few host rows: every call is compared
SHIPDATE_BASE = 10561  # 1998-12-01, days since 1970-01-01
AGGS = {"sum_qty": ("sum", "l_quantity"),
        "sum_base_price": ("sum", "l_extendedprice"),
        "sum_disc_price": ("sum", "disc_price"),
        "sum_charge": ("sum", "charge"),
        "avg_qty": ("mean", "l_quantity"),
        "avg_price": ("mean", "l_extendedprice"),
        "avg_disc": ("mean", "l_discount"),
        "count_order": ("count", None)}


def rows_per_call(cell) -> int:
    return cell.config["lineitem_rows"]


def cutoff(cell) -> int:
    return SHIPDATE_BASE - cell.traffic["delta_days"]


def make_inputs(cell, seed, device) -> dict:
    c = cell.config
    return tpch.lineitem(c["lineitem_rows"], c["scale_factor"], seed, device)


def prepare(cell, inputs, device):
    return rt.Table(dict(inputs))


def call(cell, table):
    return (rt.Query(table)
            .filter("l_shipdate", "le", cutoff(cell))
            .with_column("disc_price",
                         lambda t: t["l_extendedprice"] * (100 - t["l_discount"]))
            .with_column("charge", lambda t: t["disc_price"] * (100 + t["l_tax"]))
            .with_column("grp", lambda t: t["l_returnflag"].to(torch.int16) * 256
                         + t["l_linestatus"].to(torch.int16))
            .group_by("grp", **AGGS)
            .sort_by("grp")
            .collect())


def finish(cell, table, result) -> dict:
    return result.to_numpy()


def counters() -> dict:
    return {}
