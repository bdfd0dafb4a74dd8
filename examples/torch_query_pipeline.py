"""End-to-end query pipeline on the PyTorch/CUDA port — the same program as
examples/query_pipeline.py.

Builds two columnar tables (orders, customers), then runs:

  SELECT c.region, COUNT(*), SUM(o.amount)
  FROM orders o JOIN customers c ON o.cust = c.cust
  WHERE o.amount >= 50
  GROUP BY c.region ORDER BY c.region

on the card (``--device cuda``, the default) through the Query layer
(filter → join → group_by → sort_by), then the top 3 regions by revenue,
and cross-checks both against numpy.

Run: python examples/torch_query_pipeline.py [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from radix_sort_tpu_torch import Query, Table

    rng = np.random.default_rng(0)
    n_orders, n_cust = 200_000, 10_000

    orders = Table.from_numpy({
        "cust": rng.integers(0, n_cust, n_orders).astype(np.uint32),
        "amount": rng.integers(1, 500, n_orders).astype(np.int32),
    }, device=args.device)
    customers = Table.from_numpy({
        "cust": np.arange(n_cust, dtype=np.uint32),
        "region": (np.arange(n_cust, dtype=np.uint32) % 7),
    }, device=args.device)

    q = (Query(orders)
         .filter("amount", "ge", 50)
         .join(customers, on="cust")
         .group_by("region",
                   orders=("count", None),
                   revenue=("sum", "amount"))
         .sort_by("region"))
    res = q.collect().to_numpy()

    # numpy cross-check
    host = orders.to_numpy()
    cust, amount = host["cust"], host["amount"]
    keep = amount >= 50
    region = cust[keep] % 7
    exp_orders = np.bincount(region, minlength=7)
    exp_rev = np.bincount(region, weights=amount[keep],
                          minlength=7).astype(np.int64)

    ok = (np.array_equal(res["region"], np.arange(7, dtype=np.uint32))
          and np.array_equal(res["orders"], exp_orders)
          and np.array_equal(res["revenue"].astype(np.int64), exp_rev))

    # ordered selection on the aggregate: top 3 regions by revenue
    top = (Query(orders)
           .filter("amount", "ge", 50)
           .join(customers, on="cust")
           .group_by("region", revenue=("sum", "amount"))
           .top_k("revenue", 3)
           .collect().to_numpy())
    exp_top = np.sort(exp_rev)[::-1][:3]
    ok = ok and np.array_equal(top["revenue"].astype(np.int64), exp_top)

    print("region  orders  revenue")
    for r, o, v in zip(res["region"], res["orders"], res["revenue"]):
        print(f"{r:6d} {o:7d} {v:9d}")
    print("validation:", "OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
