"""Where the distributed layer's time goes on one card: device time by
kernel from torch.profiler, beside the host-clock time of the same calls.

    python3 scripts/dist_profile.py [--top 12] [--ranks 1,4] [--chunked]

Runs in rank processes of ``radix_sort_tpu_torch.parallel.mesh.run_ranks``:
one NCCL rank on ``cuda:0`` (``dist_sort_kv`` of u32 keys + int32 iota at
2^27, one ``ragged_all_to_all`` of 2^22 rows x 3 int32 planes to random
ranks, then BASELINE config 5's join, aggregate and sort at 2^26 probe
rows); for each other count in ``--ranks`` (a power of two), one NCCL rank
a card with the same totals where the machine has that many cards, else
gloo ranks sharing ``cuda:0`` at 2^22 rows a rank (the gloo collectives
take the CUDA tensors and move them through host memory).  Each run checks
the sort (sorted across the ranks, the payload the stable permutation),
that the exchange delivered every row, and config 5's match count and
group counts, and raises on a wrong row.
With ``--chunked`` it also profiles ``sort_kv(engine="chunked")``
of u32 KV at 2^27 in this process.  For each call: the host-clock ms (the
median of 3 after a warm-up, ended by a synchronize), the device ms a call
summed over the profiler's kernel and memcpy rows (3 calls profiled), the
idle share 1 - device / host, and the ``--top`` rows by device ms.  The
kernels are built first (``_build.build``), as chip_smoke.py builds them.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ITERS = 3


def _host_ms(fn, mesh) -> float:
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(ITERS):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _device_rows(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] += e.device_time_total / ITERS / 1e3
    return by_name


def _report(label, fn, mesh, top):
    host = _host_ms(fn, mesh)
    rows = _device_rows(fn)
    dev = sum(rows.values())
    lines = [f"{label}: host {host:.3f} ms a call, device {dev:.3f} ms, "
             f"idle share {1 - dev / host:.3f}"]
    for name, ms in rows.most_common(top):
        lines.append(f"    {ms:9.4f} ms  {name[:90]}")
    return lines


def _rank(mesh, per_rank_log2, config5_log2, top):
    import radix_sort_tpu_torch as rt
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    dev = mesh.device
    N = mesh.size << per_rank_log2
    host = rt.datasets.RandomDistributed(np.uint32, seed=0).generate(N)
    keys = mesh_lib.shard_1d(host, mesh)
    vals = mesh_lib.shard_1d(np.arange(N, dtype=np.int32), mesh)
    tag = f"{mesh.size} {mesh.backend} rank(s)"
    out = _report(f"{tag}: dist_sort_kv u32 KV 2^{N.bit_length() - 1}",
                  lambda: dist_sort.dist_sort_kv(keys, vals, mesh=mesh),
                  mesh, top)
    ks, vs, _ = dist_sort.dist_sort_kv(keys, vals, mesh=mesh)
    _check_sorted(rt, host, ks, vs, mesh)
    out.append(f"{tag}: dist_sort_kv checked: sorted across the ranks, "
               f"keys_in[payload] == keys_out, stable")
    out += _exchange(mesh, top)
    M = mesh.size << config5_log2
    pk = (np.random.default_rng(5).zipf(1.3, M) % 4096).astype(np.uint32)
    bk = np.arange(4096, dtype=np.uint32)
    probe = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": pk, "pv": np.arange(M, dtype=np.int32)}, device=dev), mesh)
    build = dist_ops.shard_table(rt.Table.from_numpy(
        {"k": bk, "bv": (bk * 7).astype(np.int32)}, device=dev), mesh)
    for name, fn in (
            ("join", lambda: dist_ops.dist_hash_join(probe, build, "k",
                                                     mesh=mesh)),
            ("aggregate", lambda: dist_ops.dist_hash_aggregate(
                probe, "k", {"n": ("count", None)}, mesh=mesh)),
            ("sort", lambda: dist_sort.dist_sort_kv(probe["k"], probe["pv"],
                                                    mesh=mesh))):
        out += _report(f"{tag}: config 5 {name} 2^{M.bit_length() - 1} rows",
                       fn, mesh, top)
    _, stats = dist_ops.dist_hash_join(probe, build, "k", mesh=mesh)
    agg, _ = dist_ops.dist_hash_aggregate(probe, "k", {"n": ("count", None)},
                                          mesh=mesh)
    res = agg.to_numpy()
    want = np.bincount(pk, minlength=4096)
    if (int(stats["match_count"]) != M or not np.array_equal(
            np.bincount(res["k"], weights=res["n"], minlength=4096), want)):
        raise RuntimeError("config 5: the join or the aggregate is wrong")
    out.append(f"{tag}: config 5 checked: {M} matches, group counts equal "
               f"np.bincount")
    return out


def _exchange(mesh, top, rows_log2=22):
    """One exchange of the layer alone: 2^rows_log2 rows x 3 int32 planes
    a rank, each row to a random rank, then the transport's share of it:
    the ``all_to_all_single`` of the same rows, already packed by
    destination.  Checks that every row arrived."""
    from radix_sort_tpu_torch.parallel import exchange
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    rows = 1 << rows_log2
    gen = torch.Generator(device=mesh.device).manual_seed(mesh.rank)
    planes = tuple(torch.randint(0, 2**31 - 1, (rows,), dtype=torch.int32,
                                 device=mesh.device, generator=gen)
                   for _ in range(3))
    dest = torch.randint(0, mesh.size, (rows,), dtype=torch.int32,
                         device=mesh.device, generator=gen)
    tag = f"{mesh.size} {mesh.backend} rank(s)"
    out = _report(f"{tag}: ragged_all_to_all 2^{rows_log2} rows x 3 int32 "
                  f"a rank", lambda: exchange.ragged_all_to_all(
                      planes, dest, mesh), mesh, top)
    got, counts, _ = exchange.ragged_all_to_all(planes, dest, mesh)
    # rows and a sum of every plane, sent and received, over the mesh
    mine = torch.stack([torch.tensor(got[0].numel(), device=mesh.device),
                        counts.to(torch.int64).sum()]
                       + [p.to(torch.int64).sum() for p in planes]
                       + [g.to(torch.int64).sum() for g in got])
    total = mesh_lib.all_reduce_sum(mine, mesh).tolist()
    if (total[0] != total[1] or total[0] != mesh.size * rows
            or total[2:5] != total[5:8]):
        raise RuntimeError(f"rank {mesh.rank}: the exchange lost rows")
    out.append(f"{tag}: ragged_all_to_all checked: every row arrived")
    order = torch.argsort(dest, stable=True)
    block = torch.stack([p[order] for p in planes], 1)
    sends = torch.bincount(dest, minlength=mesh.size)
    recvs = torch.empty_like(sends)
    ones = [1] * mesh.size
    mesh_lib.all_to_all_rows(recvs, sends, ones, ones, mesh)
    sends, recvs = sends.tolist(), recvs.tolist()
    recv_block = torch.empty((sum(recvs), 3), dtype=torch.int32,
                             device=mesh.device)
    out += _report(f"{tag}: all_to_all_single alone, the same rows packed",
                   lambda: mesh_lib.all_to_all_rows(recv_block, block, recvs,
                                                    sends, mesh), mesh, top)
    return out


def _check_sorted(rt, host, ks, vs, mesh):
    """This rank's rows of a u32 KV dist_sort_kv with an iota payload are
    the stable sort of ``host`` (the global keys): sorted here and across
    the rank boundaries, keys_in[payload] == keys_out, payloads rising
    within equal keys.  Raises on a wrong row."""
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    d = rt.dtypes
    bo = d.signed_order(d.to_sortable(ks)).to(torch.int64)
    kin = d.signed_order(d.to_sortable(d.tensor_from_numpy(host, ks.device)))
    perm = vs.to(torch.int64)
    tie = bo[1:] == bo[:-1]
    ok = (bool((bo[1:] >= bo[:-1]).all())
          and bool((kin[perm].to(torch.int64) == bo).all())
          and bool((~tie | (perm[1:] > perm[:-1])).all()))
    n = bo.numel()
    edge = (torch.stack([bo[0], bo[-1], perm[0], perm[-1]]) if n else
            torch.zeros(4, dtype=torch.int64, device=ks.device))
    edge = torch.cat([edge, torch.tensor([n], device=ks.device)])
    ends = mesh_lib.all_gather(edge, mesh).tolist()
    full = [e for e in ends if e[4]]
    ok = ok and sum(e[4] for e in ends) == host.size and all(
        (a[1], a[3]) < (b[0], b[2]) for a, b in zip(full, full[1:]))
    if not ok:
        raise RuntimeError(f"rank {mesh.rank}: dist_sort_kv is wrong")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--ranks", default="1,4")
    ap.add_argument("--chunked", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from radix_sort_tpu_torch import _build
    from radix_sort_tpu_torch.parallel import mesh as mesh_lib

    _build.build()
    print(torch.cuda.get_device_name(0), flush=True)
    for ranks in (int(r) for r in a.ranks.split(",")):
        if ranks <= torch.cuda.device_count():
            # a rank a card over NCCL, the one-rank sizes split over them
            cut = ranks.bit_length() - 1
            args = ("nccl", "cuda", (27 - cut, 26 - cut, a.top))
        else:  # ranks sharing cuda:0 over gloo
            args = ("gloo", "cuda:0", (22, 22, a.top))
        res = mesh_lib.run_ranks(_rank, ranks, backend=args[0],
                                 device=args[1], args=args[2],
                                 timeout_s=900)
        for line in res[0]:
            print(line, flush=True)
    if a.chunked:
        import radix_sort_tpu_torch as rt

        n = 1 << 27
        keys = rt.dtypes.tensor_from_numpy(
            rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n),
            "cuda")
        iota = torch.arange(n, dtype=torch.int32, device="cuda")
        run = lambda: rt.sort_kv(keys, iota, engine="chunked")  # noqa: E731
        run()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            run()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / ITERS
        rows = _device_rows(run)
        dev = sum(rows.values())
        print(f"sort_kv engine=chunked u32 KV 2^27: host {host:.3f} ms a "
              f"call, device {dev:.3f} ms, idle share {1 - dev / host:.3f}")
        for name, ms in rows.most_common(a.top):
            print(f"    {ms:9.4f} ms  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
