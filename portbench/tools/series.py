"""Run benchmark runs one after another, each in a fresh process as the
check runs them, and keep every result line.

    python3 portbench/tools/series.py --out chiprun_out/pb/x.jsonl \
        'kvsort-u32-2p27|11+12|10|0|port' 'q1-sf10|13|10|1|port'

A run is ``workload|seeds|seconds|trace|program``; several seeds joined by
``+`` run one after another, a process each.  Each result line is
appended to ``--out`` with the run's exit code, wall seconds and the
run's stderr tables (``span_breakdown``, ``rank_breakdown``); a summary
line a result is printed."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def summary(rec: dict) -> str:
    m = " ".join(f"{k}={v['value']:.6g}" for k, v in rec["metrics"].items())
    c = " ".join(f"{k}={v['value']}" for k, v in rec["checks"].items())
    d = rec["device"]
    extra = ""
    if "busy_s" in d:
        extra = f" busy_s={d['busy_s']:.4f} window_s={d['window_s']:.4f}"
    return (f"seed={rec['seed']} {rec['program']} correct={rec['correct']} "
            f"calls={rec['attempted']} failed={rec['failed']} {m} | {c} | "
            f"peak={d['memory_peak_bytes']} build_s={rec['build_s']:.1f}"
            f"{extra}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--stop-unless-correct", action="store_true",
                    help="stop after a run that fails or is not correct")
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    print(f"# card: {card()}", flush=True)
    worst = 0
    runs = [(spec, seed) for spec in args.runs
            for seed in spec.split("|")[1].split("+")]
    for spec, seed in runs:
        w, _, secs, trace, program = spec.split("|")
        cmd = [sys.executable, "portbench/run.py", "--workload", w,
               "--seed", seed, "--seconds", secs, "--trace", trace,
               "--program", program]
        t = time.time()
        try:
            p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                               timeout=args.timeout)
            rc, stdout, stderr = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout, stderr = 124, e.stdout or "", e.stderr or ""
            stdout = stdout if isinstance(stdout, str) else stdout.decode()
            stderr = stderr if isinstance(stderr, str) else stderr.decode()
        wall = time.time() - t
        worst = max(worst, rc)
        lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
        tables = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
                  for ln in stderr.splitlines()
                  if ln.startswith(("span_breakdown ", "rank_breakdown "))}
        print(f"## {w} seed {seed}: rc={rc} wall={wall:.1f}s", flush=True)
        with open(out, "a") as f:
            for ln in lines:
                rec = json.loads(ln)
                rec.update(workload=w, rc=rc, wall_s=wall, **tables)
                f.write(json.dumps(rec) + "\n")
                print("   " + summary(rec), flush=True)
                if "rank_breakdown" in tables:
                    print("   rank_breakdown "
                          + json.dumps(tables["rank_breakdown"]), flush=True)
            if rc != 0 or not lines:
                f.write(json.dumps({"workload": w, "seed": seed, "rc": rc,
                                    "stderr": stderr[-3000:]}) + "\n")
                print(stderr[-3000:], flush=True)
        good = rc == 0 and lines and all(json.loads(ln)["correct"]
                                         for ln in lines)
        if args.stop_unless_correct and program == "port" and not good:
            print("## stopping: a run failed or was not correct", flush=True)
            return max(worst, 5)
    return worst


if __name__ == "__main__":
    sys.exit(main())
