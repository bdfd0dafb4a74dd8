"""Spreads, bounds and correctness readings from result lines that
``series.py`` kept.

    python3 portbench/tools/bounds.py chiprun_out/pb/x.jsonl [...]

For each cell, the untraced full-length runs of the port are split into
sets by order (the first run of each seed opens set A, its repeat set B);
each end-to-end metric's spread is the distance between the quartiles
over the median (``window.spread``) in each set; the widest of the two,
times five and at least 1%, is the bound it suggests.  The check's own
tests are shown beside it: the mean of the two sets' spreads with each
set's run farthest from its median left out (too tight when over half
the bound) and the spread of all runs together (too loose when the bound
is over eight times it).  The numbers compared with the reference are
listed by program: the largest over the port's runs (the lower reading)
and the smallest over the control's (the upper one)."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import window  # noqa: E402


def _drop_farthest(xs):
    med = statistics.median(xs)
    far = max(range(len(xs)), key=lambda i: abs(xs[i] - med))
    return xs[:far] + xs[far + 1:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--min-seconds", type=float, default=10.0,
                    help="windows shorter than this are not full runs")
    args = ap.parse_args(argv)
    recs = [json.loads(ln) for f in args.files for ln in open(f)
            if ln.startswith("{")]
    recs = [r for r in recs if "metrics" in r]
    for cell in sorted({r["workload"] for r in recs}):
        mine = [r for r in recs if r["workload"] == cell]
        print(f"== {cell}: {len(mine)} result lines")
        full = [r for r in mine if r["program"] == "port"
                and r.get("window_s", 0) >= args.min_seconds
                and "rows_per_s" in r["metrics"]]
        sets, seen = ([], []), {}
        for r in full:
            i = seen.get(r["seed"], 0)
            seen[r["seed"]] = i + 1
            if i < 2:
                sets[i].append(r)
        for name in (full[0]["metrics"] if full else {}):
            a = [r["metrics"][name]["value"] for r in sets[0]]
            b = [r["metrics"][name]["value"] for r in sets[1]]
            if len(a) < 3 or len(b) < 3:
                continue
            sa, sb = window.spread(a), window.spread(b)
            tight = (window.spread(_drop_farthest(a))
                     + window.spread(_drop_farthest(b))) / 2
            loose = window.spread(a + b)
            bound = max(0.01, 5 * max(sa, sb))
            print(f"  {name:14s} A med {statistics.median(a):.6g} "
                  f"spread {sa:.4%} | B med {statistics.median(b):.6g} "
                  f"spread {sb:.4%} | B/A {statistics.median(b) / statistics.median(a):.4f}"
                  f" | 5x widest {bound:.4%} | tightness {tight:.4%} "
                  f"all-runs {loose:.4%}")
        for prog in ("port", "control"):
            runs = [r for r in mine if r["program"] == prog]
            if not runs:
                continue
            seeds = sorted({r["seed"] for r in runs})
            ok = sum(r["correct"] for r in runs)
            names = runs[0]["checks"]
            agg = max if prog == "port" else min
            vals = {k: agg(r["checks"][k]["value"] for r in runs)
                    for k in names}
            print(f"  {prog}: {len(runs)} runs on {len(seeds)} seeds, "
                  f"{ok} correct; {'largest' if prog == 'port' else 'smallest'}"
                  f" readings {vals}")
        traced = [r for r in mine if "breakdown" in r]
        for r in traced:
            m = " ".join(f"{k}={v['value']:.6g}" for k, v in
                         r["metrics"].items())
            print(f"  traced seed {r['seed']}: {m} busy_s="
                  f"{r['device']['busy_s']:.4f} window_s="
                  f"{r['device']['window_s']:.4f} wall {r['wall_s']:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
