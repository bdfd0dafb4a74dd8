"""The ``customer``, ``orders`` and ``lineitem`` columns TPC-H Q3 reads,
made on the device order by order.

Rules of TPC-H v3 clause 4.2.3 (dbgen):

- ``c_custkey`` is 1 .. customers; ``c_mktsegment`` is uniform over the
  five segments of clause 4.2.2.13, held as uint8 codes in ``SEGMENTS``
  order;
- ``o_orderkey`` is sparse: of each 32 consecutive keys the first 8 are
  used, so order i has key ``(i // 8) * 32 + i % 8 + 1``;
  ``o_custkey`` is uniform over [1, customers] less the multiples of 3
  (dbgen's CUST_MORTALITY: a third of the customers place no order);
  ``o_orderdate`` is uniform in [1992-01-01, 1998-08-02];
  ``o_shippriority`` is 0;
- each order has 1-7 lines; ``l_orderkey`` is its order's key, lines in
  order; ``l_shipdate`` = ``o_orderdate`` + [1, 121];
  ``l_extendedprice`` = ``l_quantity`` * ``p_retailprice(l_partkey)``
  (``gen/tpch.py``), ``l_quantity`` in [1, 50], ``l_partkey`` in
  [1, SF * 200,000]; ``l_discount`` in [0, 10] hundredths.

The line total is held at the configuration's ``lineitem_rows`` (dbgen's
count at SF10) by :func:`lines_per_order`'s rule.  Widths as a column
store holds them: identifiers int64, decimals int64 hundredths, dates
int32 days since 1970-01-01, the segment a uint8 code.
"""

from __future__ import annotations

import torch

from . import seeds
from .tpch import EPOCH_1992_01_01, EPOCH_1998_08_02, retailprice_cents

SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
            "HOUSEHOLD")
ORDERKEY_RUN, ORDERKEY_STRIDE = 8, 32  # of 32 consecutive keys, 8 used
MAX_LINES = 7


def _uniform(g, lo, hi, rows, device):  # inclusive
    return torch.randint(lo, hi + 1, (rows,), generator=g,
                         dtype=torch.int64, device=device)


def customer(rows: int, seed: int, device) -> dict:
    g = seeds.generator(device, seed, "customer")
    return {"c_custkey": torch.arange(1, rows + 1, dtype=torch.int64,
                                      device=device),
            "c_mktsegment": _uniform(g, 0, len(SEGMENTS) - 1, rows,
                                     device).to(torch.uint8)}


def orderkeys(rows: int, device) -> torch.Tensor:
    i = torch.arange(rows, dtype=torch.int64, device=device)
    return (i // ORDERKEY_RUN) * ORDERKEY_STRIDE + i % ORDERKEY_RUN + 1


def orders(rows: int, customers: int, seed: int, device) -> dict:
    g = seeds.generator(device, seed, "orders")
    # the r-th customer key that is not a multiple of 3
    r = _uniform(g, 0, customers - customers // 3 - 1, rows, device)
    return {"o_orderkey": orderkeys(rows, device),
            "o_custkey": (r // 2) * 3 + r % 2 + 1,
            "o_orderdate": _uniform(g, EPOCH_1992_01_01, EPOCH_1998_08_02,
                                    rows, device).to(torch.int32),
            "o_shippriority": torch.zeros(rows, dtype=torch.int32,
                                          device=device)}


def lines_per_order(orders_: int, total: int, seed: int,
                    device) -> torch.Tensor:
    """Each order's line count, held to ``total``: drawn uniform in [1, 7];
    then, while the counts sum to d more (fewer) lines than ``total``, the
    last |d| orders that have more than 1 (fewer than 7) lines lose (gain)
    one.  A host read of the sum each round (one round at SF10)."""
    if not orders_ <= total <= MAX_LINES * orders_:
        raise ValueError(f"{total} lines cannot be held by {orders_} "
                         f"orders of 1-{MAX_LINES} lines")
    g = seeds.generator(device, seed, "lines_per_order")
    n = _uniform(g, 1, MAX_LINES, orders_, device)
    while d := int(n.sum()) - total:
        movable = n > 1 if d > 0 else n < MAX_LINES
        from_end = torch.cumsum(movable.flip(0), 0).flip(0)
        n -= (1 if d > 0 else -1) * (movable & (from_end <= abs(d)))
    return n


def lineitem(orders_: dict, total: int, scale_factor: float, seed: int,
             device) -> dict:
    """The Q3 columns of ``total`` line items of ``orders_``, in order."""
    g = seeds.generator(device, seed, "lineitem")
    per = lines_per_order(orders_["o_orderkey"].shape[0], total, seed,
                          device)
    order = torch.repeat_interleave(per, output_size=total)
    parts = max(1, round(scale_factor * 200_000))
    qty = _uniform(g, 1, 50, total, device)
    ship = orders_["o_orderdate"][order] + _uniform(g, 1, 121, total, device)
    return {"l_orderkey": orders_["o_orderkey"][order],
            "l_extendedprice": qty * retailprice_cents(
                _uniform(g, 1, parts, total, device)),
            "l_discount": _uniform(g, 0, 10, total, device),
            "l_shipdate": ship.to(torch.int32)}


def tables(config: dict, seed: int, device) -> dict:
    """``{"customer", "orders", "lineitem"}``, each a dict of columns, at
    the configuration's row counts."""
    ords = orders(config["orders_rows"], config["customer_rows"], seed,
                  device)
    return {"customer": customer(config["customer_rows"], seed, device),
            "orders": ords,
            "lineitem": lineitem(ords, config["lineitem_rows"],
                                 config["scale_factor"], seed, device)}
