"""The ``lineitem`` columns TPC-H Q1 reads, made on the device.

Rules of TPC-H v3 clause 4.2.3 (dbgen), one row a line item:

- ``l_quantity`` uniform in [1, 50];
- ``l_partkey`` uniform in [1, SF * 200,000], and ``l_extendedprice`` =
  ``l_quantity`` * ``p_retailprice(l_partkey)``, where ``p_retailprice(pk)
  = (90000 + ((pk / 10) mod 20001) + 100 * (pk mod 1000)) / 100``;
- ``l_discount`` uniform in [0.00, 0.10], ``l_tax`` in [0.00, 0.08];
- ``o_orderdate`` uniform in [1992-01-01, 1998-08-02] (STARTDATE to
  ENDDATE - 151 days), ``l_shipdate`` = ``o_orderdate`` + [1, 121],
  ``l_receiptdate`` = ``l_shipdate`` + [1, 30];
- ``l_returnflag`` "R" or "A" at random where the receipt date is on or
  before CURRENTDATE (1995-06-17), else "N"; ``l_linestatus`` "O" where
  the ship date is after CURRENTDATE, else "F".

Widths as a column store holds TPC-H's types: decimal(15,2) as int64
hundredths (``l_quantity`` 1.00-50.00 is 100-5000), dates as int32 days
since 1970-01-01, the one-letter flags as uint8 ASCII codes.  The order
date is drawn a row, not an order of 1-7 lines: Q1 reads no order column
(the configuration lists this under ``assumed``).
"""

from __future__ import annotations

import torch

from . import seeds

EPOCH_1992_01_01 = 8035
EPOCH_1998_08_02 = 10440
CURRENTDATE = 9298  # 1995-06-17
COLUMNS = {"l_quantity": torch.int64, "l_extendedprice": torch.int64,
           "l_discount": torch.int64, "l_tax": torch.int64,
           "l_shipdate": torch.int32, "l_returnflag": torch.uint8,
           "l_linestatus": torch.uint8}


def retailprice_cents(partkey: torch.Tensor) -> torch.Tensor:
    """``p_retailprice`` in cents (int64) of each part key."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


def lineitem(rows: int, scale_factor: int, seed: int, device) -> dict:
    """The Q1 columns of ``rows`` line items on ``device``."""
    g = seeds.generator(device, seed, "lineitem")

    def uniform(lo, hi):  # inclusive
        return torch.randint(lo, hi + 1, (rows,), generator=g,
                             dtype=torch.int64, device=device)

    qty = uniform(1, 50)
    price = qty * retailprice_cents(uniform(1, scale_factor * 200_000))
    disc = uniform(0, 10)
    tax = uniform(0, 8)
    ship = uniform(EPOCH_1992_01_01, EPOCH_1998_08_02) + uniform(1, 121)
    receipt = ship + uniform(1, 30)
    r_or_a = torch.where(uniform(0, 1) == 1, ord("R"), ord("A"))
    flag = torch.where(receipt <= CURRENTDATE, r_or_a, ord("N"))
    status = torch.where(ship > CURRENTDATE, ord("O"), ord("F"))
    return {"l_quantity": qty * 100, "l_extendedprice": price,
            "l_discount": disc, "l_tax": tax,
            "l_shipdate": ship.to(torch.int32),
            "l_returnflag": flag.to(torch.uint8),
            "l_linestatus": status.to(torch.uint8)}
