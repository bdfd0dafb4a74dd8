"""Run the five BASELINE.json benchmark configs on the PyTorch/CUDA port
and record each (throughput + bit-exact validation): the port's
counterpart of ``scripts/baseline_configs.py``, with its record names.

  1. u32 key-only LSD radix sort, 1M uniform (CRadixSortCPU reference path)
  2. key-value sort (u32/u64 + payload) over zeros/range/inverted/random
  3. filter + hash aggregate (selective predicate -> GROUP BY count/sum)
  4. radix-partitioned hash join (build+probe), single device
  5. join + aggregate + sort with skewed keys over the distributed layer
     (``parallel/``), in rank processes started by ``mesh.run_ranks``

    python scripts/torch_baseline_configs.py                 # 1-5 on the card
    python scripts/torch_baseline_configs.py 2 --cfg2-log2n 27
    python scripts/torch_baseline_configs.py 5 --backend gloo --ranks 4
    python scripts/torch_baseline_configs.py --device cpu --ranks 8

Configs 1-4 run on ``--device`` (the card unless ``--device cpu``).
Config 5 runs ``--ranks`` ranks over ``--backend``: NCCL, one rank a card
(``--ranks`` defaults to the cards visible), or gloo when asked: ranks
that share card 0 (``"transport": "gloo-shared-card"``: every exchange
goes through host memory) or, with ``--device cpu``, CPU ranks.  Each
record also holds the device's name and power limit and, where a sort is
inside, the same call with its sorts on ``engine="torch_sort"``.  Times
are CUDA-event times of one call after a warm-up, median of 5 (host-clock
ms ended by a synchronize, the slowest rank's median of 3, for config 5).

Records are written through after each one to ``--out`` (default
``chiprun_out/baseline_results_torch.json``, git-ignored; never
``BASELINE_RESULTS.json``, the JAX reference's record).  The exit code is
1 when a record is not valid.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

REPS = 5
RANK_REPS = 3
ZIPF_BUILD = 4096


def _time(fn, dev) -> float:
    from radix_sort_tpu_torch.utils import profiling

    return profiling.time_ms(fn, dev, reps=REPS)


def _card(dev) -> dict:
    from radix_sort_tpu_torch.utils import profiling

    info = profiling.device_info(dev)
    return {"device": info["name"], "power_limit_w": info["power_limit_w"]}


def _suffix(log2n: int, eng: str | None = None) -> str:
    return ((f"_2^{log2n}" if log2n != 20 else "")
            + (f"_{eng}" if eng else ""))


def check_stable_kv(keys_in, keys_out, perm) -> bool:
    """On the device: ``keys_out`` is sorted, ``keys_in[perm] ==
    keys_out``, and ``perm`` rises within every run of equal keys.
    Together these pin the output to THE stable sort: a run of key k
    holds distinct input rows of key k, so no run can hold more rows than
    the input has of its key, and the runs fill n rows."""
    from radix_sort_tpu_torch import dtypes

    n = perm.numel()
    p = perm.to(torch.int64)
    if n and not bool(((p >= 0) & (p < n)).all()):
        return False
    bi = dtypes.to_sortable(keys_in)
    so = dtypes.signed_order(dtypes.to_sortable(keys_out))
    return (bool((so[1:] >= so[:-1]).all())
            and bool((bi[p] == dtypes.to_sortable(keys_out)).all())
            and bool(((so[1:] > so[:-1]) | (p[1:] > p[:-1])).all()))


# ------------------------------------------------------------- configs 1-4

def config1(dev, engine: str | None = None):
    """u32 key-only sort of 2^20 RandomDistributed keys (seed 0), against
    ``golden.cpu_radix_sort`` and ``np.sort``."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch import golden

    n = 1 << 20
    data = rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n)
    keys = rt.dtypes.tensor_from_numpy(data, dev)
    out = rt.dtypes.tensor_to_numpy(rt.sort(keys, engine=engine))
    ok = (golden.validate_bit_exact(out, golden.cpu_radix_sort(data), n)
          and golden.validate_bit_exact(out, golden.oracle_sort(data), n))
    ms = _time(lambda: rt.sort(keys, engine=engine), dev)
    ms_t = _time(lambda: rt.sort(keys, engine="torch_sort"), dev)
    yield ("config1_u32_keyonly_1M_uniform" + _suffix(20, engine),
           dict(mkeys_per_s=round(n / ms / 1e3, 1), valid=bool(ok),
                engine=engine or "auto", n=n, ms=ms, torch_sort_ms=ms_t,
                torch_sort_mkeys_per_s=round(n / ms_t / 1e3, 1),
                **_card(dev)))


CONFIG2_DTYPES = ((np.uint32, "u32"), (np.uint64, "u64"))


def config2_keys(dt, n: int, dev):
    """(dataset name, host keys or None, keys on ``dev``) of each of
    config 2's distributions (the datasets at seed 1 but
    RandomDistributed).  Above 2^22 the keys are made on the device
    (``datasets_device``) and there is no host copy."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch import datasets_device

    for ds in rt.datasets.make_datasets(dt, seed=1):
        if ds.name == "RandomDistributed":
            continue  # config names zeros/range/inverted/random
        if n <= (1 << 22):
            host = ds.generate(n)
            yield ds.name, host, rt.dtypes.tensor_from_numpy(host, dev)
        else:
            yield ds.name, None, datasets_device.generate(ds.name, dt, n,
                                                          seed=1, device=dev)


def config2(dev, log2n: int = 20, engine: str | None = None):
    """u32 and u64 keys with an int32 iota payload, stable KV sort; up to
    2^22 held against ``np.argsort(kind="stable")``, above by
    :func:`check_stable_kv` on the device."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch import golden
    from radix_sort_tpu_torch.utils import profiling

    n = 1 << log2n
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    hbm = profiling.device_hbm_gbs(dev)
    for dt, dname in CONFIG2_DTYPES:
        for ds_name, host, kd in config2_keys(dt, n, dev):
            k_out, v_out = rt.sort_kv(kd, vals, engine=engine)
            if host is not None:
                perm = golden.oracle_argsort(host)
                ok = (np.array_equal(rt.dtypes.tensor_to_numpy(k_out),
                                     host[perm])
                      and np.array_equal(v_out.cpu().numpy(), perm))
            else:
                ok = check_stable_kv(kd, k_out, v_out)
            del k_out, v_out
            ms = _time(lambda: rt.sort_kv(kd, vals, engine=engine), dev)
            ms_t = _time(lambda: rt.sort_kv(kd, vals, engine="torch_sort"),
                         dev)
            extra = {}
            if hbm:
                # minimum traffic: one read + one write of keys + payload
                min_bytes = 2 * n * (np.dtype(dt).itemsize + 4)
                extra["roofline_frac"] = round(
                    min_bytes / (ms / 1e3) / (hbm * 1e9), 4)
            yield (f"config2_kv_{dname}_{ds_name}" + _suffix(log2n, engine),
                   dict(mpairs_per_s=round(n / ms / 1e3, 1), valid=bool(ok),
                        n=n, engine=engine or "auto", **extra, ms=ms,
                        torch_sort_ms=ms_t,
                        torch_sort_mpairs_per_s=round(n / ms_t / 1e3, 1),
                        **_card(dev)))
            del kd


def config3_inputs(log2n: int) -> dict:
    """Config 3's columns: k uint32 in [0, 1000), x int32 in [0, 100)
    (numpy, seed 3)."""
    n = 1 << log2n
    rng = np.random.default_rng(3)
    return {"k": rng.integers(0, 1000, n).astype(np.uint32),
            "x": rng.integers(0, 100, n).astype(np.int32)}


def config3_query(table, config):
    """filter(k < 500) -> hash_aggregate(count, sum of x) by k."""
    from radix_sort_tpu_torch.ops import aggregate, filter as filt

    f = filt.filter_expr(table, "k", "lt", 500, config=config)
    return aggregate.hash_aggregate(
        f, "k", {"n": ("count", None), "s": ("sum", "x")}, config=config)


def config3(dev, log2n: int = 20):
    """Config 3 against ``np.bincount``."""
    import radix_sort_tpu_torch as rt

    n = 1 << log2n
    cols = config3_inputs(log2n)
    t = rt.Table.from_numpy(cols, device=dev)
    torch_cfg = rt.SortConfig(engine="torch_sort")
    out = config3_query(t, rt.DEFAULT_CONFIG).to_numpy()
    mask = cols["k"] < 500
    exp_n = np.bincount(cols["k"][mask], minlength=500)
    exp_s = np.bincount(cols["k"][mask], weights=cols["x"][mask],
                        minlength=500).astype(np.int64)
    present = np.nonzero(exp_n)[0]  # all 500 but at toy sizes
    ok = (np.array_equal(out["k"], present.astype(np.uint32))
          and np.array_equal(out["n"], exp_n[present])
          and np.array_equal(out["s"].astype(np.int64), exp_s[present]))
    ms = _time(lambda: config3_query(t, rt.DEFAULT_CONFIG), dev)
    ms_t = _time(lambda: config3_query(t, torch_cfg), dev)
    yield ("config3_filter_aggregate_1M" + _suffix(log2n),
           dict(mrows_per_s=round(n / ms / 1e3, 1), valid=bool(ok), n=n,
                ms=ms, torch_sort_ms=ms_t,
                torch_sort_mrows_per_s=round(n / ms_t / 1e3, 1),
                **_card(dev)))


def config4_inputs(log2n: int):
    """Config 4's probe (k uint32 in [0, n/2), pv iota) and unique build
    (n/4 keys, bv = 3k) columns (numpy, seed 4)."""
    n_probe, n_build = 1 << log2n, 1 << (log2n - 2)
    key_space = n_probe >> 1  # ~50% probe hit rate at any size
    rng = np.random.default_rng(4)
    pk = rng.integers(0, key_space, n_probe).astype(np.uint32)
    bk = rng.permutation(key_space)[:n_build].astype(np.uint32)
    return ({"k": pk, "pv": np.arange(n_probe, dtype=np.int32)},
            {"k": bk, "bv": (bk * 3).astype(np.int32)})


def config4_query(probe, build, config):
    from radix_sort_tpu_torch.ops import join

    return join.hash_join(probe, build, "k", config=config)


def config4(dev, log2n: int = 20):
    """Config 4: the match count against ``np.isin``, bv = 3k on every
    joined row, no overflow."""
    import radix_sort_tpu_torch as rt

    pcols, bcols = config4_inputs(log2n)
    probe = rt.Table.from_numpy(pcols, device=dev)
    build = rt.Table.from_numpy(bcols, device=dev)
    torch_cfg = rt.SortConfig(engine="torch_sort")
    res, stats = config4_query(probe, build, rt.DEFAULT_CONFIG)
    cnt = int(stats["match_count"])
    out = res.to_numpy()
    ok = (cnt == int(np.isin(pcols["k"], bcols["k"]).sum())
          and out["k"].size == cnt and not bool(stats["overflow"])
          and np.array_equal(out["bv"], (out["k"] * 3).astype(np.int32)))
    ms = _time(lambda: config4_query(probe, build, rt.DEFAULT_CONFIG), dev)
    ms_t = _time(lambda: config4_query(probe, build, torch_cfg), dev)
    n_probe = pcols["k"].size
    yield ("config4_hash_join_1M_probe_256K_build" + _suffix(log2n),
           dict(mrows_per_s=round(n_probe / ms / 1e3, 1), valid=bool(ok),
                matches=cnt, n_probe=n_probe, n_build=bcols["k"].size,
                ms=ms, torch_sort_ms=ms_t,
                torch_sort_mrows_per_s=round(n_probe / ms_t / 1e3, 1),
                **_card(dev)))


# ---------------------------------------------------------------- config 5

def config5_probe(n: int) -> np.ndarray:
    """Config 5's probe keys: zipf(1.3) % 4096, seed 5."""
    return (np.random.default_rng(5).zipf(1.3, n) % ZIPF_BUILD).astype(
        np.uint32)


def config5_tables(mesh, pk: np.ndarray):
    """This rank's shards of config 5's probe (``pk``, the global keys
    every rank passes, with an iota payload) and of its unique 4096-key
    build (bv = 7k)."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.parallel import dist_ops

    bk = np.arange(ZIPF_BUILD, dtype=np.uint32)
    probe = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": pk, "pv": np.arange(pk.size, dtype=np.int32)},
        device=mesh.device), mesh)
    build = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": bk, "bv": (bk * 7).astype(np.int32)}, device=mesh.device),
        mesh)
    return probe, build


def config5_operators(probe, build, mesh, config) -> dict:
    """Config 5's three operators on the sharded tables, as calls:
    dist_hash_join, dist_hash_aggregate(count) and dist_sort_kv of the
    probe, with ``config``'s sort engine."""
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort

    return {
        "join": lambda: dist_ops.dist_hash_join(probe, build, "k", mesh=mesh,
                                                config=config),
        "aggregate": lambda: dist_ops.dist_hash_aggregate(
            probe, "k", {"n": ("count", None)}, mesh=mesh, config=config),
        "sort": lambda: dist_sort.dist_sort_kv(probe["k"], probe["pv"],
                                               mesh=mesh, config=config),
    }


def config5_query(mesh, pk: np.ndarray) -> dict:
    """Config 5 on this rank of ``mesh`` (every rank passes the global
    probe keys ``pk``): the three operators of :func:`config5_operators`,
    checked (the join: a match a probe row, bv = 7k, the joined keys'
    counts those of pk; the aggregate: np.unique's counts; the sort: the
    stable sort of pk, gathered), then timed alone and as one query, with
    the radix kernels and with ``engine="torch_sort"``.  Returns the
    checks, the ms of each operator and of the three, and the join's host
    reads."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.ops import stream
    from radix_sort_tpu_torch.parallel import dist_ops, exchange
    from radix_sort_tpu_torch.utils import profiling

    n = pk.size
    probe, build = config5_tables(mesh, pk)
    run = config5_operators(probe, build, mesh, rt.DEFAULT_CONFIG)
    reads = (exchange.host_reads, stream.host_reads)
    joined, stats = run["join"]()
    reads = (exchange.host_reads - reads[0], stream.host_reads - reads[1])
    want_counts = np.bincount(pk, minlength=ZIPF_BUILD)
    jk = joined.columns["k"][:joined.num_rows]
    got = dist_ops.gather_rows({"k": jk}, joined.num_rows, mesh)["k"]
    join_ok = (int(stats["match_count"]) == n and not bool(stats["overflow"])
               and torch.equal(joined.columns["bv"][:joined.num_rows],
                               jk.view(torch.int32) * 7)
               and np.array_equal(np.bincount(got, minlength=ZIPF_BUILD),
                                  want_counts))
    del joined, jk, got
    res = run["aggregate"]()[0].to_numpy()
    order = np.argsort(res["k"], kind="stable")
    uk = np.nonzero(want_counts)[0].astype(np.uint32)
    agg_ok = (np.array_equal(res["k"][order], uk)
              and np.array_equal(res["n"][order], want_counts[uk]))
    ks, vs, overflow = run["sort"]()
    rows = dist_ops.gather_rows({"k": ks, "v": vs}, ks.shape[0], mesh)
    host = rt.dtypes.tensor_from_numpy
    sort_ok = not overflow and check_stable_kv(
        host(pk, "cpu"), host(rows["k"], "cpu"), host(rows["v"], "cpu"))
    del ks, vs, rows
    ms = {k: profiling.rank_ms(f, mesh, RANK_REPS) for k, f in run.items()}
    three = profiling.rank_ms(lambda: [f() for f in run.values()], mesh,
                              RANK_REPS)
    on_torch = config5_operators(probe, build, mesh,
                                 rt.SortConfig(engine="torch_sort"))
    three_t = profiling.rank_ms(lambda: [f() for f in on_torch.values()],
                                mesh, RANK_REPS)
    return {"join_valid": bool(join_ok), "agg_valid": bool(agg_ok),
            "sort_valid": bool(sort_ok), "matches": int(stats["match_count"]),
            "ms": ms, "three_ms": three, "torch_sort_three_ms": three_t,
            "join_host_reads": reads}


def config5_rank(mesh, pk_path: str) -> dict:
    """A rank of :func:`config5`: config 5 on the probe keys saved at
    ``pk_path``."""
    return config5_query(mesh, np.load(pk_path))


def transport(backend: str, device: str) -> str:
    """What carries config 5's exchanges: NCCL between cards, gloo
    through host memory for ranks sharing one card, gloo on the CPU."""
    if backend == "nccl":
        return "nccl"
    return "gloo-cpu" if torch.device(device).type == "cpu" else \
        "gloo-shared-card"


def config5(device: str, ranks: int, backend: str,
            rows_per_rank: int = 1 << 14):
    """Config 5 over ``ranks`` rank processes (``mesh.run_ranks``) at
    ``ranks * rows_per_rank`` probe rows: one NCCL rank a card, gloo ranks
    on card 0 or on the CPU (``device="cpu"``)."""
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    dev = torch.device(device)
    if ranks < 1:
        raise ValueError(f"config 5 needs at least one rank, got {ranks}: "
                         f"pass --ranks")
    if backend == "nccl" and ranks > torch.cuda.device_count():
        raise ValueError(f"{ranks} NCCL ranks need {ranks} cards, "
                         f"{torch.cuda.device_count()} are visible: pass "
                         f"--backend gloo for ranks that share a card")
    rank_dev = ("cpu" if dev.type == "cpu" else
                "cuda" if backend == "nccl" else "cuda:0")
    n = ranks * rows_per_rank
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks allocate on the same card
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "config5_probe.npy")
        np.save(path, config5_probe(n))
        res = mesh_lib.run_ranks(config5_rank, ranks, backend=backend,
                                 device=rank_dev, args=(path,),
                                 timeout_s=1200,
                                 threads=1 if rank_dev == "cpu" else None)
    r = res[0]  # every rank reads the same slowest-rank times
    valid = all(x[k] for x in res
                for k in ("join_valid", "agg_valid", "sort_valid"))
    yield ("config5_multihost_query",
           dict(devices=ranks, rows=n, wall_s=r["three_ms"] / 1e3,
                join_valid=r["join_valid"], agg_valid=r["agg_valid"],
                sort_valid=r["sort_valid"], valid=valid,
                mrows_per_s=round(n / r["three_ms"] / 1e3, 1),
                join_ms=r["ms"]["join"], aggregate_ms=r["ms"]["aggregate"],
                sort_ms=r["ms"]["sort"],
                torch_sort_ms=r["torch_sort_three_ms"],
                backend=backend, transport=transport(backend, rank_dev),
                **_card(torch.device("cuda", 0) if rank_dev != "cpu"
                        else dev)))


# -------------------------------------------------------------------- main

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="BASELINE configs on the port")
    ap.add_argument("configs", nargs="*", choices=["1", "2", "3", "4", "5"],
                    help="the configs to run (default: all five)")
    ap.add_argument("--engine", default=None,
                    help="sort engine of configs 1-2 (auto when not given; "
                         "another engine suffixes the record names)")
    ap.add_argument("--cfg2-log2n", type=int, default=20)
    ap.add_argument("--cfg34-log2n", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="config 5's ranks: nccl on a card (a rank a "
                         "card), gloo with --device cpu; gloo on a card "
                         "puts every rank on card 0")
    ap.add_argument("--ranks", type=int, default=None,
                    help="config 5's rank count (default: the cards)")
    ap.add_argument("--cfg5-rows-per-rank", type=int, default=1 << 14)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"
                                         / "baseline_results_torch.json"))
    return ap


def write_through(path: str, name: str, fields: dict) -> None:
    """Add one record to the JSON file at ``path`` now, so a later failure
    keeps it."""
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing[name] = fields
    with open(path, "w") as f:
        json.dump(existing, f, indent=2)


def run_configs(args) -> dict:
    """Every config ``args`` names, each record written through to
    ``args.out``; returns {name: fields}."""
    from radix_sort_tpu_torch.utils import cli

    if Path(args.out).resolve() == (ROOT / "BASELINE_RESULTS.json").resolve():
        raise SystemExit("--out BASELINE_RESULTS.json: that file is the JAX "
                         "reference's record; write elsewhere")
    dev = cli.resolve_device(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    gens = {
        "1": lambda: config1(dev, args.engine),
        "2": lambda: config2(dev, args.cfg2_log2n, args.engine),
        "3": lambda: config3(dev, args.cfg34_log2n),
        "4": lambda: config4(dev, args.cfg34_log2n),
        "5": lambda: config5(
            str(dev), args.ranks or torch.cuda.device_count(),
            args.backend or ("nccl" if dev.type == "cuda" else "gloo"),
            args.cfg5_rows_per_rank),
    }
    records = {}
    for which in args.configs or sorted(gens):
        for name, fields in gens[which]():
            records[name] = fields
            write_through(args.out, name, fields)
    print(f"# wrote {args.out}", flush=True)
    return records


def main(argv=None) -> int:
    records = run_configs(build_parser().parse_args(argv))
    return 0 if all(r["valid"] for r in records.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
