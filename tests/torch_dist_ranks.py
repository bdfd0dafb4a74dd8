"""Inputs and per-rank cases of the distributed layer's parity tests.

Not a test module: the functions here run on the ranks that
``radix_sort_tpu_torch.parallel.mesh.run_ranks`` spawns, which import this
module by name, so it imports neither JAX nor the JAX package.  The
``inputs_*`` functions make each case's global numpy input from a seed;
the test modules feed the same arrays to the JAX functions on a 4-device
CPU mesh.  ``run_cases(mesh, names)`` runs the port's side of the named
cases on one rank and returns {name: result}, results in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from radix_sort_tpu_torch import datasets, dtypes as tdt
from radix_sort_tpu_torch.ops import stream
from radix_sort_tpu_torch.parallel import (dist_ops, dist_sort, exchange,
                                           mesh as mesh_lib, runtime)
from radix_sort_tpu_torch.table import Table

D = 4
N_PER = 64


# ------------------------------------------------------------- inputs

def inputs_roundtrip():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1000, size=D * N_PER).astype(np.int32)
    dest = rng.integers(0, D, size=D * N_PER).astype(np.int32)
    return vals, dest


def inputs_multibucket(G=2):
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 10_000, size=D * N_PER).astype(np.int32)
    dest = rng.integers(0, D, size=D * N_PER).astype(np.int32)
    sub = rng.integers(0, G, size=D * N_PER).astype(np.int32)
    return vals, dest, sub


def inputs_mixed_dtypes():
    """A row of every payload width: int16, u32, f32, u64 and f64 columns,
    destinations, and a drop mask."""
    rng = np.random.default_rng(2)
    n = D * N_PER
    cols = (rng.integers(-2**15, 2**15, n).astype(np.int16),
            rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            rng.standard_normal(n).astype(np.float32),
            rng.integers(0, 2**64, n, dtype=np.uint64),
            rng.standard_normal(n))
    dest = rng.integers(0, D, n).astype(np.int32)
    drop = rng.random(n) < 0.3
    return cols, dest, drop


def dataset_keys(name, n=1 << 12, seed=3, dtype=np.uint32):
    for ds in datasets.make_datasets(dtype, seed=seed):
        if ds.name == name:
            return ds.generate(n)
    raise KeyError(name)


SORT_INPUTS = {
    **{f"dist_{name}": (lambda name=name: (dataset_keys(name), None))
       for name in ("Zeros", "RandomDistributed", "Random", "Range",
                    "InvertedRange")},
    "kv_stable": lambda: (
        np.array([7, 7, 7, 7, 1, 1, 1, 1] * 128, dtype=np.uint32),
        np.arange(1024, dtype=np.int32)),
    "non_divisible": lambda: (
        datasets.RandomDistributed(np.int32, seed=1).generate(1000), None),
    "i64": lambda: (
        datasets.RandomDistributed(np.int64, seed=2).generate(2048), None),
    "f32": lambda: (_f32_keys(), None),
    "zipf": lambda: (
        (np.random.default_rng(0).zipf(1.5, size=4096) % 1000).astype(
            np.uint32), None),
    "overlap_Zeros": lambda: (dataset_keys("Zeros", seed=5), None),
    "overlap_RandomDistributed": lambda: (
        dataset_keys("RandomDistributed", seed=5), None),
    "overlap_kv": lambda: (
        np.random.default_rng(9).integers(0, 50, size=1 << 10).astype(
            np.uint32), np.arange(1 << 10, dtype=np.int32)),
    "u32_full_kv": lambda: (
        np.random.default_rng(21).integers(0, 2**32, 3001, dtype=np.uint64)
        .astype(np.uint32), np.arange(3001, dtype=np.int32)),
    "u64_full_kv": lambda: (_u64_tied_keys(), np.arange(3001, dtype=np.int32)),
    # an 8-byte payload: one int64 plane through the exchange, whose odd
    # row counts put it at odd word offsets of the blocks
    "u64_full_kv_i64": lambda: (_u64_tied_keys(),
                                np.arange(3001, dtype=np.int64)),
    "tiny": lambda: (np.array([5, 1, 3], dtype=np.uint32),
                     np.arange(3, dtype=np.int32)),
    "u8_kv": lambda: (_narrow_keys(np.uint8), np.arange(3001, dtype=np.int32)),
    "f16_kv": lambda: (_narrow_keys(np.float16),
                       np.arange(3001, dtype=np.int32)),
}


def _narrow_keys(dtype, n=3001, seed=23):
    """1- and 2-byte keys over every bit pattern (NaN payloads for
    float16), ties included, the dtype's extremes (+-inf, +-0.0 and
    subnormals for float16) planted."""
    d = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << (8 * d.itemsize), n).astype(
        f"u{d.itemsize}").view(d)
    k[500:900] = k[7]
    if d.kind == "f":
        sub = np.finfo(d).smallest_subnormal
        k[:7] = [np.inf, -np.inf, 0.0, -0.0, sub, -sub, np.nan]
    else:
        k[:2] = [np.iinfo(d).min, np.iinfo(d).max]
    return k


def _f32_keys():
    rng = np.random.default_rng(5)
    data = rng.standard_normal(D * 700 + 3).astype(np.float32)
    data[:4] = [np.inf, -np.inf, 0.0, -0.0]
    return data


def _u64_tied_keys():
    """Full-range u64 keys (top bits set) with a block of ties."""
    rng = np.random.default_rng(22)
    k = rng.integers(0, 2**64, 3001, dtype=np.uint64)
    k[100:700] = k[5]
    return k


# (case, overlap_chunks) of the dist_sort parity tests
SORT_CASES = ([(f"dist_{n}", g) for n in ("Zeros", "RandomDistributed",
                                          "Random", "Range", "InvertedRange")
               for g in (1, 2)]
              + [(c, g) for c in ("kv_stable", "non_divisible", "u32_full_kv",
                                  "u64_full_kv", "u64_full_kv_i64", "tiny")
                 for g in (1, 2)]
              + [("i64", 2), ("f32", 2), ("zipf", 2), ("overlap_Zeros", 4),
                 ("overlap_RandomDistributed", 4), ("overlap_kv", 2)]
              + [(c, g) for c in ("u8_kv", "f16_kv") for g in (1, 2)])


def inputs_assign(dtype, G):
    """A global chunk of full-range keys with heavy ties on splitter values,
    and the D*G - 1 splitters (ascending, one duplicated)."""
    rng = np.random.default_rng(31 + G)
    n = D * 512
    if np.dtype(dtype) == np.uint64:
        keys = rng.integers(0, 2**64, n, dtype=np.uint64)
        top = np.uint64(1) << np.uint64(63)
    else:
        keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        top = np.uint32(1 << 31)
    spl = np.sort(rng.choice(keys, D * G - 1, replace=False))
    spl[len(spl) // 2] = spl[len(spl) // 2 - 1]  # a duplicated splitter
    spl[-1] = spl[-1] | top  # a splitter at or above 2^31 (2^63)
    spl = np.sort(spl)
    keys[rng.random(n) < 0.4] = spl[len(spl) // 2]  # ties on the duplicate
    keys[rng.random(n) < 0.1] = spl[-1]
    return keys, spl


def agg_inputs(name):
    if name == "aggregate":
        rng = np.random.default_rng(5)
        return (rng.integers(0, 40, size=2048).astype(np.uint32),
                rng.integers(-50, 50, size=2048).astype(np.int32))
    if name in ("aggregate_u8", "aggregate_f16"):
        dtype = np.uint8 if name == "aggregate_u8" else np.float16
        keys = _narrow_keys(dtype, n=2048, seed=29)
        keys[1000:] = keys[:1048]  # every key in a group of two or more
        return keys, np.random.default_rng(6).integers(
            -50, 50, size=2048).astype(np.int32)
    rng = np.random.default_rng(11)  # skew: 3 groups on 4 ranks
    return (rng.integers(0, 3, size=2048).astype(np.uint32),
            np.ones(2048, np.int32))


def join_inputs(name):
    """(probe columns, build columns, build num_rows): the JAX tests'
    tables, the build padded to a multiple of the mesh."""
    if name == "join":
        rng = np.random.default_rng(7)
        pk = rng.integers(0, 500, size=1024).astype(np.uint32)
        bk = np.arange(0, 500, 2, dtype=np.uint32)
        pad, mult = 512 - bk.size, 10
    else:
        rng = np.random.default_rng(13)
        bk = np.array([0, 2, 4, 6], dtype=np.uint32)
        pk = rng.integers(0, 8, size=1024).astype(np.uint32)
        pad, mult = 4, 3
    build = {"k": np.concatenate([bk, np.zeros(pad, np.uint32)]),
             "bv": np.concatenate([bk.astype(np.int32) * mult,
                                   np.zeros(pad, np.int32)])}
    probe = {"k": pk, "pv": np.arange(pk.size, dtype=np.int32)}
    return probe, build, bk.size


def config5_inputs(n=D * (1 << 10)):
    """BASELINE config 5 (scripts/baseline_configs.py): skewed probe keys
    zipf(1.3) % 4096 with an iota payload, a unique 4096-key build with
    bv = 7k."""
    rng = np.random.default_rng(5)
    pk = (rng.zipf(1.3, n) % 4096).astype(np.uint32)
    bk = np.arange(4096, dtype=np.uint32)
    return ({"k": pk, "pv": np.arange(n, dtype=np.int32)},
            {"k": bk, "bv": (bk * 7).astype(np.int32)})


def topk_inputs(name):
    """(columns, num_rows, k, largest) of the JAX dist_top_k tests."""
    if name == "unique":
        keys = np.random.default_rng(17).permutation(1024).astype(np.uint32)
        return {"k": keys, "v": (keys * 3 + 1).astype(np.int32)}, None, 10, \
            True
    if name == "unique_smallest":
        cols, _, _, _ = topk_inputs("unique")
        return cols, None, 7, False
    if name == "padding":
        keys = np.arange(512, dtype=np.int64)
        keys[300:] = 10_000_000
        return {"k": keys}, 300, 5, True
    if name == "k_exceeds_per_device":
        keys = np.random.default_rng(23).permutation(256).astype(
            np.int32) - 128
        return {"k": keys}, None, 100, True
    if name == "fewer_rows_than_k":
        return {"k": np.arange(64, dtype=np.uint32)}, 3, 8, True
    keys = np.random.default_rng(29).integers(0, 4, size=512).astype(
        np.uint32)
    return {"k": keys, "row": np.arange(512, dtype=np.int32)}, None, 50, True


TOPK_CASES = ("unique", "unique_smallest", "padding", "k_exceeds_per_device",
              "fewer_rows_than_k", "ties")


# ------------------------------------------------------------- rank side

def _np(t):
    return tdt.tensor_to_numpy(t)


def _table(cols, num_rows, mesh):
    """This rank's shard of the global numpy table."""
    return dist_ops.shard_table(
        Table.from_numpy(cols, num_rows=num_rows, device="cpu"), mesh)


def _exchange_cases(mesh):
    out = {}
    vals, dest = inputs_roundtrip()
    v, d = mesh_lib.shard_1d(vals, mesh), mesh_lib.shard_1d(dest, mesh)
    (got,), counts, ovf = exchange.ragged_all_to_all((v,), d, mesh)
    out["roundtrip"] = (_np(got), _np(counts), ovf)
    (got,), counts, ovf = exchange.ragged_all_to_all(
        (v,), torch.zeros_like(d), mesh, capacity=1)
    out["overflow"] = (_np(got), _np(counts), ovf)
    (got,), counts, ovf = exchange.ragged_all_to_all((v,), d, mesh,
                                                     capacity=N_PER)
    out["no_overflow"] = ovf

    vals, dest, sub = inputs_multibucket()
    v, d, s = (mesh_lib.shard_1d(a, mesh) for a in (vals, dest, sub))
    from radix_sort_tpu_torch.ops import partition as part_ops
    (parted,), cnts, starts = part_ops.stable_partition(
        s * D + d, (v,), D * 2, method="stream")
    per_g = []
    for g in range(2):
        (got,), rc, _ = exchange.packed_all_to_all(
            (parted,), cnts[g * D:(g + 1) * D], starts[g * D:(g + 1) * D],
            mesh)
        per_g.append((_np(got), _np(rc)))
    out["multibucket"] = per_g

    cols, dest, drop = inputs_mixed_dtypes()
    got, rc, _ = exchange.ragged_all_to_all(
        tuple(mesh_lib.shard_1d(c, mesh) for c in cols),
        mesh_lib.shard_1d(dest, mesh), mesh,
        drop_mask=mesh_lib.shard_1d(drop, mesh))
    out["mixed_drop"] = ([_np(g) for g in got], _np(rc))

    out["health"] = runtime.health_check(mesh)
    info = runtime.initialize()  # a group is running: describe it
    m = mesh_lib.make_mesh(device="cpu")
    errors = []
    for kw in ({"num_devices": D + 1}, {"backend": "nccl"}):
        try:
            mesh_lib.make_mesh(**kw)
        except ValueError:
            errors.append(sorted(kw))
    out["running_group"] = ((info.process_id, info.num_processes),
                            (m.rank, m.size, m.backend), errors)
    out["shard"] = _np(mesh_lib.shard_1d(np.arange(1001, dtype=np.int64),
                                         mesh))
    out["replicate"] = _np(mesh_lib.replicate(
        torch.full((3,), 10 + mesh.rank, dtype=torch.int32), mesh))
    out["spy"] = _spy(mesh)
    return out


def _spy(mesh):
    """Calls of stream.partition_planes (the radix kernels' stable pass)
    and of the torch.sort engine while the exchange, dist_sort_kv,
    dist_hash_aggregate and dist_hash_join run.  (On the CPU the plain
    version of the pass ranks tiles with torch.sort; on a card it is the
    kernel, so torch.sort itself is not what is counted.)"""
    from radix_sort_tpu_torch.ops import sort as sort_ops

    calls = {"partition_planes": 0, "torch_sort_engine": 0}
    real_pp, real_ts = stream.partition_planes, sort_ops._torch_sort_engine

    def pp(*a, **kw):
        calls["partition_planes"] += 1
        return real_pp(*a, **kw)

    def ts(*a, **kw):
        calls["torch_sort_engine"] += 1
        return real_ts(*a, **kw)

    stream.partition_planes, sort_ops._torch_sort_engine = pp, ts
    try:
        vals, dest = inputs_roundtrip()
        exchange.ragged_all_to_all((mesh_lib.shard_1d(vals, mesh),),
                                   mesh_lib.shard_1d(dest, mesh), mesh)
        after_exchange = dict(calls)
        keys, _ = SORT_INPUTS["zipf"]()
        dist_sort.dist_sort_kv(mesh_lib.shard_1d(keys, mesh), None,
                               mesh=mesh)
        probe, build = config5_inputs()
        t = _table(probe, None, mesh)
        dist_ops.dist_hash_aggregate(t, "k", {"n": ("count", None)},
                                     mesh=mesh)
        dist_ops.dist_hash_join(t, _table(build, None, mesh), "k",
                                mesh=mesh)
    finally:
        stream.partition_planes = real_pp
        sort_ops._torch_sort_engine = real_ts
    return after_exchange, calls


def _sort_cases(mesh):
    out = {}
    for case, G in SORT_CASES:
        keys, vals = SORT_INPUTS[case]()
        k = mesh_lib.shard_1d(keys, mesh)
        v = None if vals is None else mesh_lib.shard_1d(vals, mesh)
        ks, vs, ovf = dist_sort.dist_sort_kv(k, v, mesh=mesh,
                                             overlap_chunks=G)
        out[(case, G)] = (_np(ks), None if vs is None else _np(vs), ovf)
    keys, _ = SORT_INPUTS["dist_Range"]()
    out["dist_sort"] = _np(dist_sort.dist_sort(mesh_lib.shard_1d(keys, mesh),
                                               mesh=mesh))
    for dtype in (np.uint32, np.uint64):
        for G in (1, 2):
            keys, spl = inputs_assign(dtype, G)
            bits = tdt.to_sortable(mesh_lib.shard_1d(keys, mesh))
            sb = tdt.to_sortable(tdt.tensor_from_numpy(spl, "cpu"))
            out[("assign", np.dtype(dtype).name, G)] = _np(
                dist_sort._assign_destinations(bits, sb, D * G, mesh))
    try:  # a layout other than shard_1d's
        dist_sort.dist_sort_kv(torch.arange(mesh.rank + 1), mesh=mesh)
        out["bad_layout"] = None
    except ValueError as e:
        out["bad_layout"] = str(e)
    return out


def _ops_cases(mesh):
    out = {}
    for G in (1, 2):
        for name in ("aggregate", "aggregate_skew", "aggregate_u8",
                     "aggregate_f16"):
            keys, vals = agg_inputs(name)
            res, ovf = dist_ops.dist_hash_aggregate(
                _table({"g": keys, "x": vals}, None, mesh), "g",
                {"n": ("count", None), "s": ("sum", "x")}, mesh=mesh,
                overlap_chunks=G)
            out[(name, G)] = (res.to_numpy(), ovf)
        for name in ("join", "join_skew"):
            probe, build, brows = join_inputs(name)
            res, stats = dist_ops.dist_hash_join(
                _table(probe, None, mesh), _table(build, brows, mesh), "k",
                mesh=mesh, overlap_chunks=G)
            out[(name, G)] = (res.to_numpy(), int(stats["match_count"]),
                              bool(stats["overflow"]))
        probe, build = config5_inputs()
        pt, bt = _table(probe, None, mesh), _table(build, None, mesh)
        joined, st = dist_ops.dist_hash_join(pt, bt, "k", mesh=mesh,
                                             overlap_chunks=G)
        agg, _ = dist_ops.dist_hash_aggregate(pt, "k", {"n": ("count", None)},
                                              mesh=mesh, overlap_chunks=G)
        ks, vs, _ = dist_sort.dist_sort_kv(pt["k"], pt["pv"], mesh=mesh,
                                           overlap_chunks=G)
        out[("config5", G)] = (joined.to_numpy(), int(st["match_count"]),
                               agg.to_numpy(), _np(ks), _np(vs))
    for name in TOPK_CASES:
        cols, rows, k, largest = topk_inputs(name)
        res = dist_ops.dist_top_k(_table(cols, rows, mesh), "k", k,
                                  largest=largest, mesh=mesh)
        out[("topk", name)] = (res.to_numpy(), int(res.num_rows))
    return out


CASES = {"exchange": _exchange_cases, "sort": _sort_cases,
         "ops": _ops_cases}


def run_cases(mesh, which: str):
    """The port's side of one test module's cases on this rank."""
    return CASES[which](mesh)


def fail_on_rank_one(mesh):
    """For the launcher's failure test: rank 1 raises."""
    if mesh.rank == 1:
        raise RuntimeError("rank one fails on purpose")
    return mesh.rank


def nccl_case(mesh):
    """One NCCL rank on the card: a full-range u32 KV dist_sort_kv and
    config 5's join and aggregate, with the radix kernels' launches."""
    from radix_sort_tpu_torch.ops import cuda_radix

    cuda_radix.reset_launch_counts()
    keys, vals = SORT_INPUTS["u32_full_kv"]()
    ks, vs, _ = dist_sort.dist_sort_kv(mesh_lib.shard_1d(keys, mesh),
                                       mesh_lib.shard_1d(vals, mesh),
                                       mesh=mesh)
    probe, build = config5_inputs()
    pt, bt = _table(probe, None, mesh), _table(build, None, mesh)
    agg, _ = dist_ops.dist_hash_aggregate(pt, "k", {"n": ("count", None)},
                                          mesh=mesh)
    _, stats = dist_ops.dist_hash_join(pt, bt, "k", mesh=mesh)
    torch.cuda.synchronize()
    return {"sort": (_np(ks), _np(vs)), "agg": agg.to_numpy(),
            "matches": int(stats["match_count"]),
            "launches": cuda_radix.launch_counts()}


def config5_script_case(mesh, n):
    """scripts/torch_baseline_configs.py's config 5 on this rank at ``n``
    probe rows: its operators' results (numpy) and config5_query's checks.
    The test puts scripts/ on the path the ranks start from."""
    import torch_baseline_configs as tbc

    from radix_sort_tpu_torch.config import DEFAULT_CONFIG

    pk = tbc.config5_probe(n)
    probe, build = tbc.config5_tables(mesh, pk)
    ops = tbc.config5_operators(probe, build, mesh, DEFAULT_CONFIG)
    joined, stats = ops["join"]()
    agg, _ = ops["aggregate"]()
    ks, vs, overflow = ops["sort"]()
    checks = tbc.config5_query(mesh, pk)
    return {"joined": joined.to_numpy(), "matches": int(stats["match_count"]),
            "agg": agg.to_numpy(), "ks": _np(ks), "vs": _np(vs),
            "overflow": bool(overflow),
            "checks": {k: checks[k] for k in ("join_valid", "agg_valid",
                                              "sort_valid")}}
