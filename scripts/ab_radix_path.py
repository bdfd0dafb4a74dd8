"""Time the radix path of two checkouts of the port on one card, in turns.

    python3 scripts/ab_radix_path.py PARENT_DIR CHANGE_DIR [--order 0,1,1,0]

Each turn is a fresh process started in one tree's root, so it imports that
tree's ``radix_sort_tpu_torch`` and builds its kernels there.  It times the
radix-path phases of ``chip_smoke.py`` with the same method as
``chip_smoke.time_ms`` (CUDA events around one call, median of 5 after a
warm-up): ``sort_kv`` of u32 keys + int32 iota at 2^27 over the five
distributions, ``sort_kv`` of u64 keys at 2^27, ``sort`` of u32 keys at
2^25, config 3 (filter -> aggregate over 2^26 rows) and config 4 (a 2^20 x
2^18 join).  Every sort is validated on the card (sorted, payload is the
permutation that produced the keys) and configs 3 and 4 against numpy.

The last line is a JSON object with every turn's times; the lines before
it a table: each phase's times by tree, the spread of each tree's turns
(max - min) and the change's mean over the parent's.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPS = 5


def _time_ms(torch, fn) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"validation failed: {what}")


def worker() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import aggregate, filter as filt, join

    dev = torch.device("cuda", 0)
    times = {}
    cases = [(ds, 27, True) for ds in rt.datasets.make_datasets(np.uint32, 0)]
    cases += [(rt.datasets.RandomDistributed(np.uint64, seed=0), 27, True),
              (rt.datasets.RandomDistributed(np.uint32, seed=0), 25, False)]
    for ds, log2n, kv in cases:
        n = 1 << log2n
        keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev)
        what = (f"{'sort_kv' if kv else 'sort'} "
                f"{np.dtype(ds.dtype).name} {ds.name} 2^{log2n}")
        bits = rt.dtypes.to_sortable(keys)
        if kv:
            iota = torch.arange(n, dtype=torch.int32, device=dev)
            ko, perm = rt.sort_kv(keys, iota)
            _check(bool((bits[perm.long()] == rt.dtypes.to_sortable(ko))
                        .all()), f"{what}: keys_in[payload] != keys_out")
            run = lambda: rt.sort_kv(keys, iota)  # noqa: E731
        else:
            ko = rt.sort(keys)
            run = lambda: rt.sort(keys)  # noqa: E731
        so = rt.dtypes.to_sortable(ko)
        _check(int(bits.sum()) == int(so.sum()), f"{what}: key sum")
        so = rt.dtypes.signed_order(so)
        _check(bool((so[1:] >= so[:-1]).all()), f"{what}: not sorted")
        times[what] = _time_ms(torch, run)
        del keys, ko, bits, so

    n = 1 << 26
    rng = np.random.default_rng(3)
    k3 = rng.integers(0, 1000, n).astype(np.uint32)
    v3 = rng.integers(0, 100, n).astype(np.int32)
    t = rt.Table.from_numpy({"k": k3, "x": v3}, device=dev)

    def config3():
        f = filt.filter_expr(t, "k", "lt", 500)
        return aggregate.hash_aggregate(
            f, "k", {"n": ("count", None), "s": ("sum", "x")})

    out = config3().to_numpy()
    _check(np.array_equal(out["n"], np.bincount(k3[k3 < 500],
                                                minlength=500)), "config3")
    times["config3 2^26 rows"] = _time_ms(torch, config3)
    del t

    rng = np.random.default_rng(4)
    pk = rng.integers(0, 1 << 19, 1 << 20).astype(np.uint32)
    bk = rng.permutation(1 << 19)[:1 << 18].astype(np.uint32)
    probe = rt.Table.from_numpy(
        {"k": pk, "pv": np.arange(1 << 20, dtype=np.int32)}, device=dev)
    build = rt.Table.from_numpy(
        {"k": bk, "bv": (bk * 3).astype(np.int32)}, device=dev)
    _, stats = join.hash_join(probe, build, "k")
    _check(int(stats["match_count"]) == int(np.isin(pk, bk).sum()),
           "config4")
    times["config4 2^20 x 2^18"] = _time_ms(
        torch, lambda: join.hash_join(probe, build, "k"))
    return {"device": torch.cuda.get_device_name(0), "times": times}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--order", default="0,1,1,0")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker()), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give two trees: PARENT_DIR CHANGE_DIR")
    trees = [os.path.abspath(t) for t in args.trees]
    turns = []
    for i in (int(x) for x in args.order.split(",")):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"],
            cwd=trees[i], capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": trees[i]})
        if res.returncode != 0:
            print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
            return res.returncode
        turn = json.loads(res.stdout.strip().splitlines()[-1])
        turn["tree"] = i
        turns.append(turn)
        print(f"[ab] turn {len(turns)}: tree {i} ({trees[i]}) done",
              flush=True)
    phases = list(turns[0]["times"])
    print(f"{'phase':44s} {'parent ms':>22s} {'change ms':>22s} "
          f"{'spread p/c':>15s} {'change/parent':>13s}")
    for ph in phases:
        by = [[t["times"][ph] for t in turns if t["tree"] == i]
              for i in (0, 1)]
        print(f"{ph:44s} {' '.join(f'{v:.3f}' for v in by[0]):>22s} "
              f"{' '.join(f'{v:.3f}' for v in by[1]):>22s} "
              f"{max(by[0]) - min(by[0]):7.3f}/{max(by[1]) - min(by[1]):.3f}"
              f" {np.mean(by[1]) / np.mean(by[0]):13.3f}")
    print(json.dumps({"trees": trees, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
