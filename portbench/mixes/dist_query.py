"""BASELINE config 5 through the program's distributed layer: a skewed
join, aggregate and sort of a fact table hash-partitioned over the ranks.

Each rank holds ``rows_per_rank`` probe rows, made on its own card from
the seed and its rank: ``k`` uint32, ``zipf(s) % modulus``
(``gen/zipf.py``), and ``pv`` int32, the row's global id (rank r's rows
are global rows [r * n, (r + 1) * n)).  The build side is the
``modulus`` unique keys with ``bv = 7 k`` (int32), cut into the ranks'
shards by ``dist_ops.shard_table``.  One call runs, with the default
``SortConfig``:

    dist_hash_join(probe, build, "k")
    dist_hash_aggregate(probe, "k", {"n": ("count", None)})
    dist_sort_kv(probe["k"], probe["pv"])

and ``finish`` brings the aggregate's groups to the host on every rank
(``ShardedTable.to_numpy``, a collective), as a user reads them; the join
and the sort stay on the cards.  A call's rows are every rank's probe
rows.  The mix drives one rank; the harness runs it on every rank of the
mesh in lockstep (``portbench/launch.py``)."""

from __future__ import annotations

import torch

import radix_sort_tpu_torch as rt
from portbench.gen import zipf
from radix_sort_tpu_torch.ops import stream
from radix_sort_tpu_torch.parallel import dist_ops, dist_sort, exchange
from radix_sort_tpu_torch.parallel import mesh as mesh_lib

AGGS = {"n": ("count", None)}


def rows_per_call(cell) -> int:
    return cell.config["rows_per_rank"] * cell.chips


def make_inputs(cell, seed, device, ranks) -> dict:
    """This rank's probe shard and the whole build side, on ``device``.
    ``ranks`` (the harness's view of the mesh) and ``global_keys``, which
    makes every rank's keys again from the seed, are for the reference."""
    c = cell.config
    n = c["rows_per_rank"]
    key = c["probe_key"]

    def global_keys():
        return zipf.global_keys(n, ranks.size, key["s"], key["modulus"],
                                seed, device)

    pv = torch.arange(ranks.rank * n, (ranks.rank + 1) * n,
                      dtype=torch.int32, device=device)
    bk = torch.arange(c["build_rows"], dtype=torch.int32, device=device)
    return {"k": zipf.keys(n, key["s"], key["modulus"], seed, ranks.rank,
                           device),
            "pv": pv, "bk": bk.view(torch.uint32),
            "bv": bk * c["build_value_factor"], "rows_per_rank": n,
            "ranks": ranks, "global_keys": global_keys}


def prepare(cell, inputs, device) -> dict:
    mesh = mesh_lib.make_mesh(device=device)
    build = dist_ops.shard_table(
        rt.Table({"k": inputs["bk"], "bv": inputs["bv"]}), mesh)
    return {"mesh": mesh, "build": build,
            "probe": rt.Table({"k": inputs["k"], "pv": inputs["pv"]})}


def call(cell, state):
    mesh, probe = state["mesh"], state["probe"]
    joined, stats = dist_ops.dist_hash_join(probe, state["build"], "k",
                                            mesh=mesh)
    agg, _ = dist_ops.dist_hash_aggregate(probe, "k", AGGS, mesh=mesh)
    ks, vs, overflow = dist_sort.dist_sort_kv(probe["k"], probe["pv"],
                                              mesh=mesh)
    return joined, stats, agg, (ks, vs, overflow)


def finish(cell, state, raw) -> dict:
    joined, stats, agg, (ks, vs, overflow) = raw
    groups = agg.to_numpy()
    out = {f"join_{n}": c for n, c in joined.columns.items()}
    out.update(match_count=stats["match_count"],
               join_overflow=stats["overflow"], agg_k=groups["k"],
               agg_n=groups["n"], sort_k=ks, sort_v=vs,
               sort_overflow=overflow)
    return out


def counters() -> dict:
    """Host reads of the distributed layer and of the sorts under it."""
    return {"host_reads": exchange.host_reads + stream.host_reads}
