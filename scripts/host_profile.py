"""Where the host's time goes in one small call of the port on one card.

    python3 scripts/host_profile.py [[PARENT_DIR] CHANGE_DIR] [--top 15]
        [--calls 200]

For each tree (a directory whose root holds a ``radix_sort_tpu_torch``
package: this checkout by default, or a parent unpacked with ``git archive
<commit> | tar -x -C build/parent``), a fresh process started in that
tree's root (``scripts/turns.py``) takes, on the card:

- the host's enqueue of one call (``chip_smoke.enqueue_us``:
  ``time.perf_counter`` around the call with no sync, the card idle before
  it, median of 20) of ``sort`` of 2^20 u32 RandomDistributed keys
  (BASELINE config 1), of the same ``sort`` with ``engine="torch_sort"``,
  and of config 4's join (2^20 x 2^18) on both engines;
- one call's CUDA-event ms of the same calls (``chip_smoke.time_ms``);
- cProfile of ``--calls`` calls of that ``sort`` and of a tenth as many
  joins (the card synchronised before and after them): the ``--top``
  frames by own time and by cumulative time, in microseconds a call
  (cProfile's own cost is inside them, so they add up to more than the
  enqueue rows; a ctypes call's C time is its caller's own time).

Each tree's frames are printed, then a table of the times by tree
(``turns.print_table``), then one JSON line with every run.  Needs one
card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys

import numpy as np

import turns


def _frames(prof: cProfile.Profile, calls: int, top: int) -> list:
    """The ``top`` frames by own and by cumulative time, µs a call."""
    # (file, line, fn) -> (calls, primitive calls, own s, cumulative s, ..)
    stats = pstats.Stats(prof).stats
    rows = []
    for key, col in (("own", 2), ("cumulative", 3)):
        rows.append(f"-- by {key} time, us a call over {calls} calls --")
        for (file, line, fn), st in sorted(stats.items(),
                                           key=lambda kv: -kv[1][col])[:top]:
            rows.append(f"{st[2] / calls * 1e6:9.2f} own "
                        f"{st[3] / calls * 1e6:9.2f} cum "
                        f"{st[1] / calls:6.1f} calls a call  "
                        f"{os.path.basename(file)}:{line}({fn})")
    return rows


def profile(fn, calls: int, top: int) -> list:
    """cProfile of ``calls`` calls of ``fn`` (warmed; the card synchronised
    before and after them, not between)."""
    import torch

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    return _frames(prof, calls, top)


def worker(top: int, calls: int) -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import radix_sort_tpu_torch as rt

    dev = torch.device("cuda", 0)
    keys = rt.dtypes.tensor_from_numpy(
        rt.datasets.RandomDistributed(np.uint32, seed=0).generate(1 << 20),
        dev)
    out = rt.sort(keys)
    so = rt.dtypes.signed_order(rt.dtypes.to_sortable(out))
    if not bool((so[1:] >= so[:-1]).all()):
        raise SystemExit("config 1's sort is not sorted")
    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    import torch_baseline_configs as tbc

    pcols, bcols = tbc.config4_inputs(20)
    probe = rt.Table.from_numpy(pcols, device=dev)
    build = rt.Table.from_numpy(bcols, device=dev)
    calls_of = {
        "config1 sort u32 2^20": lambda: rt.sort(keys),
        "config1 sort u32 2^20 engine=torch_sort":
            lambda: rt.sort(keys, engine="torch_sort"),
        "config4 join 2^20 x 2^18": lambda: tbc.config4_query(
            probe, build, rt.DEFAULT_CONFIG),
        "config4 join 2^20 x 2^18 engine=torch_sort":
            lambda: tbc.config4_query(probe, build,
                                      rt.SortConfig(engine="torch_sort")),
    }
    times = {}
    for what, fn in calls_of.items():
        times[f"{what} host enqueue us"] = turns.enqueue_us(fn)
        times[f"{what} one call ms"] = turns.time_ms(fn)
    frames = {what: profile(calls_of[what], n, top)
              for what, n in (("config1 sort u32 2^20", calls),
                              ("config4 join 2^20 x 2^18", calls // 10))}
    return {"device": torch.cuda.get_device_name(0), "times": times,
            "frames": frames}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.top, args.calls)), flush=True)
        return 0
    paths = args.trees or [str(turns.ROOT)]
    if len(paths) > 2:
        ap.error("give at most two trees: [PARENT_DIR] CHANGE_DIR")
    trees = dict(zip(("parent", "change")[-len(paths):],
                     map(os.path.abspath, paths)))
    runs = turns.in_turns(__file__, trees, list(trees), "--top",
                          str(args.top), "--calls", str(args.calls))
    for r in runs:
        for what, lines in r["frames"].items():
            print(f"[frames] {r['tree']} ({trees[r['tree']]}), {what}, "
                  f"{r['device']}:")
            for line in lines:
                print(f"  {line}")
    turns.print_table(runs)
    print(json.dumps({"trees": trees, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
