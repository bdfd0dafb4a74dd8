"""The distributed layer on ``torch.distributed``: one process a rank.

Port of ``radix_sort_tpu/parallel/``.  A :class:`~.mesh.Mesh` is a process
group with this process's rank and device; NCCL joins ranks on separate
cards, gloo joins CPU ranks and several ranks that share one card (a gloo
exchange goes through host memory).  ``mesh.run_ranks`` starts the ranks
of one machine; ``runtime.initialize`` joins a launch by ``torchrun``.

    mesh       — Mesh, make_mesh, shard_1d, replicate, run_ranks
    runtime    — initialize, health_check
    exchange   — ragged_all_to_all, packed_all_to_all (exact, ragged)
    dist_sort  — dist_sort_kv, dist_sort (sample sort + rebalance)
    dist_ops   — ShardedTable, dist_hash_aggregate, dist_hash_join,
                 dist_top_k
"""
