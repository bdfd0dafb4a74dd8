"""Time the radix path of two checkouts of the port on one card, in turns.

    python3 scripts/ab_radix_path.py PARENT_DIR CHANGE_DIR [--order 0,1,1,0]

Each turn is a fresh process started in one tree's root, so it imports that
tree's ``radix_sort_tpu_torch`` and builds its kernels there.  It times the
radix-path phases of ``chip_smoke.py`` with the same method as
``chip_smoke.time_ms`` (CUDA events around one call, median of 5 after a
warm-up): ``sort_kv`` of u32 keys + int32 iota at 2^27 over the five
distributions, ``sort_kv`` of u64 keys at 2^27 (RandomDistributed and
Zeros), ``sort`` of u32 keys at
2^25 (the headline's call) and at 2^20 (config 1, with
``engine="torch_sort"`` beside it), ``sort_kv`` of uint8 keys
(RandomDistributed, Zeros) and float16 keys at 2^27 (the narrow pass),
config 3 (filter -> aggregate over 2^26 rows), config 4 (a 2^20 x 2^18
join, beside ``engine="torch_sort"``) and ``[dist1]``'s sorts on a world
of one NCCL rank in the worker (``dist_sort_kv`` u32 KV 2^27 and config 5
at 2^26 rows).  Every sort is validated on the card (sorted, payload is the
permutation that produced the keys) and configs 3 and 4 against numpy.
Every sort also has a "device" row, ``chip_smoke.device_ms`` of the same
call (50 back to back, the host's work out of the window); "host enqueue
us" rows (config 1, with torch.sort beside it, the headline and config
4 on both engines) are
``chip_smoke.enqueue_us``: ``time.perf_counter`` around one call with no
sync, the card idle before it, median of 20; "idle share" is 1 -
torch.profiler's device time over the event time of 10 back-to-back
key-only sorts at 2^25, as ``chip_smoke.py`` ``[profile]`` takes it.

The last line is a JSON object with every turn's times; the lines before
it a table: each phase's times by tree and the change's mean over the
parent's.  Turns, timers and the table are ``scripts/turns.py``'s.  Needs
one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

import turns


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"validation failed: {what}")


def _idle_share(run, sorts: int = 10) -> float:
    """1 - profiled device time / event time of ``sorts`` calls."""
    def loop():
        for _ in range(sorts):
            run()

    wall = turns.time_ms(loop)
    return 1 - turns.profiled_ms(loop) / wall


def worker() -> dict:
    sys.path.insert(0, os.getcwd())
    import torch

    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import aggregate, filter as filt, join

    dev = torch.device("cuda", 0)
    times = {}
    cases = [(ds, 27, True) for ds in rt.datasets.make_datasets(np.uint32, 0)]
    cases += [(rt.datasets.RandomDistributed(np.uint64, seed=0), 27, True),
              (rt.datasets.Zeros(np.uint64), 27, True),
              (rt.datasets.RandomDistributed(np.uint32, seed=0), 25, False),
              (rt.datasets.RandomDistributed(np.uint32, seed=0), 20, False)]
    cases += [((name, dt), 27, True) for name, dt in (
        ("RandomDistributed", np.uint8), ("Zeros", np.uint8),
        ("RandomDistributed", np.float16))]
    for ds, log2n, kv in cases:
        n = 1 << log2n
        if isinstance(ds, tuple):  # made on the card
            keys = rt.datasets_device.generate(ds[0], ds[1], n, seed=9,
                                               device=dev)
            what = (f"sort_kv {np.dtype(ds[1]).name} {ds[0]} 2^{log2n}")
        else:
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
        times[what] = turns.time_ms(run)
        times[f"{what} device"] = turns.device_ms(run)
        if log2n in (20, 25):  # config 1 and the headline
            times[f"{what} host enqueue us"] = turns.enqueue_us(run)
        if log2n == 20:  # config 1 beside torch.sort
            base = lambda: rt.sort(keys, engine="torch_sort")  # noqa: E731
            times[f"{what} engine=torch_sort"] = turns.time_ms(base)
            times[f"{what} engine=torch_sort host enqueue us"] = (
                turns.enqueue_us(base))
        if log2n == 25:
            times["idle share sort u32 2^25 x10"] = _idle_share(run)
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
    times["config3 2^26 rows"] = turns.time_ms(config3)
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
    for name, cfg in (("", rt.DEFAULT_CONFIG),
                      (" engine=torch_sort", rt.SortConfig(
                          engine="torch_sort"))):
        run = lambda: join.hash_join(probe, build, "k", config=cfg)  # noqa
        times[f"config4 2^20 x 2^18{name}"] = turns.time_ms(run)
        times[f"config4 2^20 x 2^18{name} host enqueue us"] = (
            turns.enqueue_us(run))
    del probe, build
    times.update(dist1(rt, dev))
    return {"device": torch.cuda.get_device_name(0), "times": times}


def dist1(rt, dev) -> dict:
    """[dist1]'s sorts, in this process: a world of one NCCL rank on the
    card (``mesh.make_mesh``), ``dist_sort_kv`` of u32 keys + int32 iota
    at 2^27 (RandomDistributed, Zeros; checked against ``sort_kv``) and
    BASELINE config 5 at 2^26 probe rows (``torch_baseline_configs.
    config5_query``, which checks it): its three operators as one query."""
    import torch

    from radix_sort_tpu_torch.parallel import dist_sort, mesh as pmesh

    sys.path.insert(0, os.path.join(os.getcwd(), "scripts"))
    import torch_baseline_configs as tbc

    m = pmesh.make_mesh(device=dev)
    times = {}
    n = 1 << 27
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    for ds in (rt.datasets.RandomDistributed(np.uint32, seed=0),
               rt.datasets.Zeros(np.uint32)):
        keys = rt.dtypes.tensor_from_numpy(ds.generate(n), dev)
        ks, vs, ovf = dist_sort.dist_sort_kv(keys, iota, mesh=m)
        ko, po = rt.sort_kv(keys, iota)
        _check(not bool(ovf) and torch.equal(ks.view(torch.int32),
                                             ko.view(torch.int32))
               and torch.equal(vs, po),
               f"[dist1] dist_sort_kv {ds.name}: differs from sort_kv")
        times[f"[dist1] dist_sort_kv u32 {ds.name} 2^27"] = turns.time_ms(
            lambda: dist_sort.dist_sort_kv(keys, iota, mesh=m))
        del keys, ks, vs, ko, po
    del iota
    r = tbc.config5_query(m, tbc.config5_probe(1 << 26))
    _check(all(r[k] for k in ("join_valid", "agg_valid", "sort_valid")),
           "[dist1] config 5")
    times["[dist1] config5 2^26 rows"] = r["three_ms"]
    return times


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
    trees = dict(zip(("parent", "change"),
                     (os.path.abspath(t) for t in args.trees)))
    order = [("parent", "change")[int(i)] for i in args.order.split(",")]
    runs = turns.in_turns(__file__, trees, order)
    turns.print_table(runs)
    print(json.dumps({"trees": trees, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
