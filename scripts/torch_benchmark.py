"""Benchmark sweep of the PyTorch/CUDA port, its counterpart of
``scripts/benchmark.py``: parity with the reference's benchmark corpus
(SURVEY.md §2 #24: scripts/performance.ps1 sweeping n = 2^25..2^1 and
Performance/perfToOverallCSV.py aggregation).

  python scripts/torch_benchmark.py --max-log2 25 --min-log2 10 \\
      --datatypes u32,u64 --engine auto --perf-to-csv
  python scripts/torch_benchmark.py --min-log2 6 --max-log2 10 \\
      --device cpu --perf-to-stdout

One row per (n, dtype, dataset), n = 2^max-log2 down to 2^min-log2 by
--step, in the JAX sweep's order.  Each row is a key-only
``harness.SortTask`` run through ``harness.run_compute_task``: the sort
timed on the device (the card unless ``--device cpu``), the host baselines
(``np.sort`` and the native radix sort of ``native/`` where it is built,
``golden.cpu_radix_sort`` where not) unless ``--no-cpu-baselines``, the
per-kernel columns (histogram / scan / reorder: one pass of
``digit_histogram``, the block-base scan and ``rank_scatter`` in base-table
mode, scaled by the pass count) under the ``radix`` engine unless
``--no-phases``, and the whole output held against ``np.sort``.  An
invalid row stops the sweep.  The CSV (the reference's schema plus
Mkeys/s, roofline share and engine, ``utils.csvio``) is rewritten after
every row, to ``--csv-dir`` (default ``chiprun_out/``, git-ignored; never
``Performance/``, which holds the reference's CSVs).
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NAME_TO_NP = {"u32": np.uint32, "i32": np.int32, "u64": np.uint64,
              "i64": np.int64, "f32": np.float32, "f64": np.float64}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="benchmark sweep of the port")
    ap.add_argument("--min-log2", type=int, default=16)
    ap.add_argument("--max-log2", type=int, default=25)
    ap.add_argument("--step", type=int, default=3)
    ap.add_argument("--datatypes", default="u32")
    ap.add_argument("--datasets", default="")
    ap.add_argument("--engine", default="auto")
    ap.add_argument("--cpu-baselines", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="time np.sort + native radix per row (reference "
                         "parity: CRadixSortTask.cpp:172-222 runs CPU "
                         "baselines on every row)")
    ap.add_argument("--phases", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="populate per-kernel columns (histogram/scan/"
                         "reorder) under the radix engine (reference "
                         "parity: RadixSortGPU.cpp:37-56)")
    ap.add_argument("--perf-to-csv", action="store_true")
    ap.add_argument("--perf-to-stdout", action="store_true")
    ap.add_argument("--csv-dir", default=str(ROOT / "chiprun_out"))
    ap.add_argument("--device", default="cuda")
    return ap


def enumerate_rows(args) -> list:
    """(log2 n, dtype name, dataset) of every row, in sweep order."""
    from radix_sort_tpu_torch import datasets as ds_lib

    if args.datatypes in ("all", ""):
        dtype_names = ["u32", "i32", "u64", "i64"]
    else:
        dtype_names = [s for s in args.datatypes.split(",") if s]
    wanted = {s for s in args.datasets.split(",") if s}
    return [(logn, dname, ds)
            for logn in range(args.max_log2, args.min_log2 - 1, -args.step)
            for dname in dtype_names
            for ds in ds_lib.make_datasets(NAME_TO_NP[dname], seed=0)
            if not wanted or ds.name in wanted]


def csv_path(args) -> str:
    """A fresh timestamped CSV path in ``--csv-dir``, made; raises for the
    reference's ``Performance/``."""
    from radix_sort_tpu_torch.utils import csvio

    if Path(args.csv_dir).resolve() == (ROOT / "Performance").resolve():
        raise SystemExit("--csv-dir Performance: that directory holds the "
                         "reference's CSVs; write elsewhere")
    os.makedirs(args.csv_dir, exist_ok=True)
    return csvio.timestamped_path(args.csv_dir)


def sweep(args) -> list:
    """Run every row of ``args`` (parsed by :func:`build_parser`); returns
    the ``harness.TaskResult`` of each.  Raises on an invalid row."""
    from radix_sort_tpu_torch import harness
    from radix_sort_tpu_torch.config import SortConfig
    from radix_sort_tpu_torch.ops import sort as sort_ops
    from radix_sort_tpu_torch.utils import cli, csvio, profiling

    dev = cli.resolve_device(args.device)
    card = profiling.device_info(dev)
    cfg = SortConfig(engine=args.engine)
    engine = sort_ops._dispatch_engine(cfg.engine)
    phases = args.phases and engine == "radix"
    print(f"# device={card['name']} power_limit_w={card['power_limit_w']} "
          f"hbm={profiling.device_hbm_gbs(dev)} GB/s engine={engine}",
          flush=True)
    if args.phases and not phases:
        print(f"# engine {engine} has no radix-phase decomposition; "
              "per-kernel columns stay 0", flush=True)
    path = csv_path(args) if args.perf_to_csv else None
    results = []
    for logn, dname, ds in enumerate_rows(args):
        task = harness.SortTask(
            NAME_TO_NP[dname], ds,
            options=cli.RadixSortOptions(num_elements=1 << logn),
            config=cfg, with_values=False, device=dev)
        res = harness.run_compute_task(task, cpu_baselines=args.cpu_baselines,
                                       phases=phases)
        results.append(res)
        r = res.row
        flag = "" if res.valid else "  !!INVALID"
        if r.roofline_frac > 1.0:
            # above the memory roofline is impossible: the timing is wrong
            flag += "  !!NOISY"
        print(f"2^{logn} {dname:4s} {ds.name:18s} {r.avg_total_gpu:9.4f} ms "
              f"{r.mkeys_per_sec:10.1f} Mkeys/s roof={r.roofline_frac:6.1%} "
              f"hist/scan/reorder {r.avg_histogram:.4f}/{r.avg_scan:.4f}/"
              f"{r.avg_reorder:.4f} ms np.sort {r.avg_total_stl_cpu:.3f} ms "
              f"native {r.avg_total_rdx_cpu:.3f} ms{flag}", flush=True)
        if not res.valid:
            raise RuntimeError(f"validation failed: {dname} {ds.name} "
                               f"n=2^{logn}")
        if path is not None:  # every finished row survives a later failure
            csvio.write_csv([x.row for x in results], path=path)
    if path is not None:
        print(f"# wrote {path}", flush=True)
    if args.perf_to_stdout:
        csvio.write_rows([x.row for x in results], sys.stdout)
        sys.stdout.flush()
    return results


def main(argv=None) -> int:
    sweep(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
