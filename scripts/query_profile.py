"""Where the query path's device time goes: torch.profiler's kernel rows of
one call of each of ``chip_smoke.py``'s query-path workloads at its full
size, summed by kernel name, largest first.

    python3 scripts/query_profile.py [--top 12]

The workloads: ``Query.window`` with every kind over 2^26 rows, the
SELECT of examples/query_pipeline.py over 2^26 orders, ``Query.sort_by``
on three keys over 2^26 rows, and ``hash_aggregate`` by
``method="segment"`` and ``"scan"`` on config 3's 2^26 rows.  Each line
gives a kernel's device ms in the call, its launches and its share of the
call's device time.  First, ``[indexing]`` lines time the ways torch
gathers and scatters 2^26 values, which those workloads use.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0 and ch == "(":
            break
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out)[-70:]


def breakdown(what: str, fn, top: int) -> None:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in rows:
        ms, n = by.get(short(e.name), (0.0, 0))
        by[short(e.name)] = (ms + e.device_time_total / 1e3, n + 1)
    total = sum(ms for ms, _ in by.values())
    print(f"[profile] {what}: device {total:.3f} ms in {len(rows)} "
          f"kernels", flush=True)
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:9.3f} ms  {n:4d}x  {ms / total:6.3f}  {name}",
              flush=True)


def indexing(n: int, dev) -> None:
    """Device ms (chip_smoke.device_ms) of the ways torch moves 2^26 int32
    values by an int64 index: a random permutation, and run starts (a
    monotone index, each value read by ~1024 rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                      generator=gen)
    perm = torch.randperm(n, device=dev, generator=gen)
    starts = (torch.arange(n, device=dev) >> 10) << 10
    out = torch.empty_like(x)
    cases = {
        "x[perm]": lambda: x[perm],
        "index_select(x, perm)": lambda: torch.index_select(x, 0, perm),
        "gather(x, perm)": lambda: torch.gather(x, 0, perm),
        "x[starts]": lambda: x[starts],
        "index_select(x, starts)": lambda: torch.index_select(x, 0, starts),
        "out[perm] = x": lambda: out.__setitem__(perm, x),
        "out.index_copy_(perm, x)": lambda: out.index_copy_(0, perm, x),
        "out.scatter_(perm, x)": lambda: out.scatter_(0, perm, x),
        "x.clone()": lambda: x.clone(),
    }
    for what, fn in cases.items():
        print(f"[indexing] 2^26 int32 {what}: {cs.device_ms(fn):.4f} ms",
              flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args()
    card = cs.phase_device()
    cs.phase_build()
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import aggregate, filter as filt

    dev = torch.device("cuda", 0)
    n = 1 << 26
    indexing(n, dev)

    cols = cs.window_columns(n, seed=26)
    t = rt.Table.from_numpy(cols, num_rows=n - cs.PADDING, device=dev)
    breakdown("Query.window, 11 specs, 2^26 rows",
              lambda: rt.Query(t).window("p", "o", **cs.WINDOW_SPECS)
              .collect(), args.top)
    del t, cols

    rng = np.random.default_rng(0)
    orders = rt.Table.from_numpy(
        {"cust": rng.integers(0, 1 << 22, n).astype(np.uint32),
         "amount": rng.integers(1, 500, n).astype(np.int32)}, device=dev)
    ids = np.arange(1 << 22, dtype=np.uint32)
    customers = rt.Table.from_numpy({"cust": ids, "region": ids % 7},
                                    device=dev)
    breakdown("SELECT of examples/query_pipeline.py, 2^26 orders",
              lambda: rt.Query(orders).filter("amount", "ge", 50)
              .join(customers, on="cust")
              .group_by("region", orders=("count", None),
                        revenue=("sum", "amount"))
              .sort_by("region").collect(), args.top)
    del orders, customers

    t = rt.Table.from_numpy(
        {"a": rng.integers(0, 1 << 10, n).astype(np.uint32),
         "b": rng.integers(-2**15, 2**15, n).astype(np.int16),
         "c": rng.standard_normal(n).astype(np.float32),
         "row": np.arange(n, dtype=np.int32)}, num_rows=n - cs.PADDING,
        device=dev)
    breakdown("Query.sort_by u32, int16 desc, f32, 2^26 rows",
              lambda: rt.Query(t).sort_by(
                  "a", "b", "c", descending=[False, True, False]).collect(),
              args.top)
    del t

    rng = np.random.default_rng(3)
    t = rt.Table.from_numpy(
        {"k": rng.integers(0, 1000, n).astype(np.uint32),
         "x": rng.integers(0, 100, n).astype(np.int32),
         "f": (rng.random(n) * 100).astype(np.float32)}, device=dev)
    aggs = {"n": ("count", None), "s": ("sum", "x"), "lo": ("min", "x"),
            "hi": ("max", "x"), "m": ("mean", "x"), "fs": ("sum", "f")}
    for method in ("segment", "scan"):
        breakdown(f"hash_aggregate(method={method!r}), config 3, 2^26 rows",
                  lambda: aggregate.hash_aggregate(
                      filt.filter_expr(t, "k", "lt", 500), "k", aggs,
                      method=method), args.top)
    print(f"[profile] card {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
