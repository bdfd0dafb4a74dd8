"""The plain reference of TPC-H Q1, in plain PyTorch.

From the same ``lineitem`` columns the benchmark handed the program:
the rows with ``l_shipdate`` on or before the cutoff, grouped by
(``l_returnflag``, ``l_linestatus``) through ``torch.unique``, each sum
an exact int64 ``index_add_``, each average the float64 quotient of the
exact sum by the count (the configuration's guarantee), groups in key
order.  ``compare`` counts the groups, counts, sums and averages that
differ from it; every limit is 0: the answer is exact.

The control is the same query with its decimal sums taken in float64
rather than exact int64 (the step a later change would be tempted by):
Q1's discounted price and charge sums pass 2^53 at SF10, where float64
rounds."""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"groups_wrong": 0, "counts_wrong": 0, "sums_wrong": 0,
          "avgs_wrong": 0}
SUMS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge")
AVGS = ("avg_qty", "avg_price", "avg_disc")
SHIPDATE_BASE = 10561  # 1998-12-01


def _columns(cell, inputs):
    keep = inputs["l_shipdate"] <= SHIPDATE_BASE - cell.traffic["delta_days"]
    price = inputs["l_extendedprice"][keep]
    disc = inputs["l_discount"][keep]
    disc_price = price * (100 - disc)
    return {
        "grp": (inputs["l_returnflag"][keep].to(torch.int64) * 256
                + inputs["l_linestatus"][keep].to(torch.int64)),
        "l_quantity": inputs["l_quantity"][keep], "l_extendedprice": price,
        "l_discount": disc, "disc_price": disc_price,
        "charge": disc_price * (100 + inputs["l_tax"][keep])}


def _query(cell, inputs, sum_dtype) -> dict:
    c = _columns(cell, inputs)
    groups, inv, count = torch.unique(c["grp"], sorted=True,
                                      return_inverse=True, return_counts=True)
    g = groups.shape[0]

    def total(col):
        return torch.zeros(g, dtype=sum_dtype, device=col.device).index_add_(
            0, inv, col.to(sum_dtype))

    sums = {name: total(c[col]) for name, col in
            zip(SUMS, ("l_quantity", "l_extendedprice", "disc_price",
                       "charge"))}
    cnt = count.to(torch.float64)
    avgs = {"avg_qty": sums["sum_qty"].to(torch.float64) / cnt,
            "avg_price": sums["sum_base_price"].to(torch.float64) / cnt,
            "avg_disc": total(c["l_discount"]).to(torch.float64) / cnt}
    out = {"grp": groups, "count_order": count}
    out.update({k: torch.round(v).to(torch.int64) if v.is_floating_point()
                else v for k, v in sums.items()})
    out.update(avgs)
    return {k: v.cpu().numpy() for k, v in out.items()}


def expected(cell, inputs: dict) -> dict:
    return _query(cell, inputs, torch.int64)


def compare(cell, inputs: dict, expected: dict, answer: dict) -> dict:
    g = expected["grp"].shape[0]
    got_g = np.asarray(answer.get("grp", []))
    if got_g.shape != (g,) or not np.array_equal(got_g.astype(np.int64),
                                                 expected["grp"]):
        return {"groups_wrong": g, "counts_wrong": g,
                "sums_wrong": g * len(SUMS), "avgs_wrong": g * len(AVGS)}

    def wrong(names, bits=False):
        total = 0
        for n in names:
            a, e = np.asarray(answer[n]), expected[n]
            if bits:  # float64 compared bit for bit
                a, e = a.astype(np.float64).view(np.int64), e.view(np.int64)
            total += int((a.astype(np.int64) != e.astype(np.int64)).sum())
        return total

    return {"groups_wrong": 0, "counts_wrong": wrong(["count_order"]),
            "sums_wrong": wrong(SUMS), "avgs_wrong": wrong(AVGS, bits=True)}


def control(cell, inputs: dict) -> dict:
    out = _query(cell, inputs, torch.float64)
    out["grp"] = out["grp"].astype(np.int16)
    return out
