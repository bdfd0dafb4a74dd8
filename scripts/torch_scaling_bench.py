"""Weak-scaling harness for the port's distributed sort (BASELINE.json:
≥85% weak-scaling efficiency at 2+ hosts): the counterpart of
``scripts/scaling_bench.py``.

Keeps the rows a rank constant and sweeps mesh sizes, reporting the
``dist_sort`` wall time of the slowest rank (host clock, each call ended
by a synchronize of the rank's card; median of 3 after a warm-up) and the
efficiency against the smallest mesh.  Each output is gathered and held
against ``np.sort``; ``--check-ops`` also runs ``dist_hash_aggregate`` and
``dist_hash_join`` at each size, validated against numpy.  Prints one JSON
list, a record a mesh size.

    python scripts/torch_scaling_bench.py --rows-per-dev 4194304
    python scripts/torch_scaling_bench.py --backend gloo --mesh-sizes 2,4
    python scripts/torch_scaling_bench.py --device cpu --mesh-sizes 1,2,4 \\
        --rows-per-dev 1024 --check-ops

The ranks are processes (``mesh.run_ranks``), started once for the
largest mesh; a smaller mesh is a process group of the first D ranks
while the others wait.  NCCL puts one rank on each card and needs
``torch.cuda.device_count() >= D``; anything else is ``--backend gloo``,
chosen by the caller: every rank on card 0 (an exchange goes through host
memory) or, with ``--device cpu``, CPU ranks.  Each record names its
transport.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

REPS = 3


def check_ops(mesh, rows: int):
    """dist aggregate + join at mesh size D, validated against numpy (row
    count scales with D like the sort's): (agg_ok, join_ok)."""
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.parallel import dist_ops

    D = mesh.size
    rng = np.random.default_rng(D)
    n = D * rows
    gk = rng.integers(0, max(4, n // 64), size=n).astype(np.uint32)
    xs = rng.integers(-100, 100, size=n).astype(np.int32)
    t = dist_ops.shard_table(rt.Table.from_numpy({"g": gk, "x": xs},
                                                 device=mesh.device), mesh)
    out, _ = dist_ops.dist_hash_aggregate(
        t, "g", {"n": ("count", None), "s": ("sum", "x")}, mesh=mesh)
    res = out.to_numpy()
    order = np.argsort(res["g"], kind="stable")
    uk, inv = np.unique(gk, return_inverse=True)
    agg_ok = (np.array_equal(res["g"][order], uk)
              and np.array_equal(res["n"][order], np.bincount(inv))
              and np.array_equal(res["s"][order].astype(np.int64),
                                 np.bincount(inv, weights=xs).astype(
                                     np.int64)))

    bk = np.arange(0, max(2, n // 128), 2, dtype=np.uint32)
    build = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": bk, "bv": bk.astype(np.int32) * 3}, device=mesh.device), mesh)
    pk = rng.integers(0, bk.size * 2, size=n).astype(np.uint32)
    probe = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": pk, "pv": np.arange(n, dtype=np.int32)}, device=mesh.device),
        mesh)
    jout, stats = dist_ops.dist_hash_join(probe, build, "k", mesh=mesh)
    jres = jout.to_numpy()
    exp_matches = int(np.isin(pk, bk).sum())
    join_ok = (int(stats["match_count"]) == exp_matches
               and jres["k"].size == exp_matches
               and np.array_equal(jres["bv"],
                                  jres["k"].astype(np.int32) * 3))
    return agg_ok, join_ok


def one_size(mesh, rows: int, with_ops: bool) -> dict:
    """dist_sort of ``mesh.size * rows`` uniform u32 keys (seed 0) on
    ``mesh``: its slowest-rank ms and its validity."""
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib
    from radix_sort_tpu_torch.utils import profiling

    n = mesh.size * rows
    keys = np.random.default_rng(0).integers(0, 1 << 32, size=n,
                                             dtype=np.uint32)
    local = mesh_lib.shard_1d(keys, mesh)
    ms = profiling.rank_ms(lambda: dist_sort.dist_sort(local, mesh=mesh),
                           mesh, REPS)
    out = dist_sort.dist_sort(local, mesh=mesh)
    got = dist_ops.gather_rows({"k": out}, out.shape[0], mesh)["k"]
    rec = {"devices": mesh.size, "rows": n, "wall_s": ms / 1e3,
           "valid": bool(np.array_equal(got, np.sort(keys)))}
    if with_ops:
        rec["agg_valid"], rec["join_valid"] = (
            bool(v) for v in check_ops(mesh, max(64, rows // 16)))
    return rec


def scaling_rank(mesh, sizes, rows: int, with_ops: bool) -> dict:
    """A rank of :func:`scaling`: every mesh size of ``sizes`` on the
    first D ranks (a process group each; the rest wait at a barrier).
    Returns the rank's records (rank 0 is in every mesh, and prints a line
    each) and its kernel launches."""
    import torch.distributed as dist

    from radix_sort_tpu_torch.ops import cuda_merge, cuda_radix
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib
    from torch_baseline_configs import transport

    records = []
    for D in sizes:
        group = (None if D == mesh.size
                 else dist.new_group(list(range(D))))  # every rank calls it
        if mesh.rank < D:
            sub = mesh_lib.Mesh(mesh.rank, D, mesh.device, mesh.backend,
                                group)
            rec = one_size(sub, rows, with_ops)
            rec["weak_scaling_eff"] = (records[0]["wall_s"] / rec["wall_s"]
                                       if records else 1.0)
            rec["backend"] = mesh.backend
            rec["transport"] = transport(mesh.backend, str(mesh.device))
            records.append(rec)
            if mesh.rank == 0:
                print(f"D={D} rows={rec['rows']} wall="
                      f"{rec['wall_s'] * 1e3:.3f} ms eff="
                      f"{rec['weak_scaling_eff']:.2%} valid={rec['valid']}"
                      + (f" agg={rec['agg_valid']} join={rec['join_valid']}"
                         if with_ops else "")
                      + f" ({rec['transport']})", flush=True)
        dist.barrier()
    return {"records": records, "launches": {
        **cuda_radix.launch_counts(), **cuda_merge.launch_counts()}}


def scaling(sizes, rows: int, with_ops: bool, backend: str,
            device: str):
    """Every mesh size of ``sizes`` with ``rows`` rows a rank over
    ``backend`` (NCCL: a rank a card; gloo: every rank on card 0, or on
    the CPU when ``device`` is "cpu"): rank 0's records, and each rank's
    kernel launches."""
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib
    from radix_sort_tpu_torch.utils import profiling

    dev = torch.device(device)
    world = max(sizes)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"a NCCL mesh of {world} ranks needs {world} cards, "
                         f"{torch.cuda.device_count()} are visible: pass "
                         f"--backend gloo for ranks that share a card")
    rank_dev = ("cpu" if dev.type == "cpu" else
                "cuda" if backend == "nccl" else "cuda:0")
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the ranks allocate on the same card
    res = mesh_lib.run_ranks(
        scaling_rank, world, backend=backend, device=rank_dev,
        args=(list(sizes), rows, with_ops), timeout_s=1200,
        threads=1 if rank_dev == "cpu" else None)
    card = profiling.device_info("cpu" if rank_dev == "cpu" else
                                 torch.device("cuda", 0))
    records = res[0]["records"]
    for rec in records:
        rec.update(device=card["name"], power_limit_w=card["power_limit_w"])
    return records, [r["launches"] for r in res]


def main(argv=None) -> int:
    from radix_sort_tpu_torch.utils import cli

    ap = argparse.ArgumentParser(description="weak scaling of dist_sort")
    ap.add_argument("--rows-per-dev", type=int, default=1 << 14)
    ap.add_argument("--mesh-sizes", default="",
                    help="comma-separated mesh sizes (default: 1, 2, 4, 8 "
                         "up to the cards under NCCL)")
    ap.add_argument("--check-ops", action="store_true",
                    help="also validate the distributed hash aggregate and "
                         "hash join at each mesh size")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="nccl on a card (a rank a card), gloo with "
                         "--device cpu; gloo on a card puts every rank on "
                         "card 0")
    args = ap.parse_args(argv)
    dev = cli.resolve_device(args.device)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    sizes = [int(s) for s in args.mesh_sizes.split(",") if s] or [
        d for d in (1, 2, 4, 8)
        if backend == "gloo" or d <= torch.cuda.device_count()]
    records, _ = scaling(sizes, args.rows_per_dev, args.check_ops, backend,
                         str(dev))
    print(json.dumps(records))
    ok = all(r["valid"] and r.get("agg_valid", True)
             and r.get("join_valid", True) for r in records)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
