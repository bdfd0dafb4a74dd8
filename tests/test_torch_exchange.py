"""The port's exchange, mesh and runtime (radix_sort_tpu_torch.parallel)
against the JAX package's on 4 ranks.

The port's side runs once for the whole module on 4 gloo ranks spawned by
``mesh.run_ranks`` (``torch_dist_ranks.run_cases``); the JAX side runs the
same numpy inputs under shard_map on a mesh of 4 of the 8 CPU devices.
The exchange is exact where the JAX one has fixed-capacity slots, so the
rows are compared with each slot's valid prefix, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dist_ranks as R
from radix_sort_tpu.ops import partition as jpart
from radix_sort_tpu.parallel import exchange as jex, mesh as jmesh
from radix_sort_tpu.parallel import runtime as jruntime
from radix_sort_tpu_torch.parallel import exchange, mesh as mesh_lib, runtime

D = R.D


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(D)


@pytest.fixture(scope="module")
def port():
    """Every rank's results of the module's cases, from one spawn."""
    return mesh_lib.run_ranks(R.run_cases, D, backend="gloo", device="cpu",
                              args=("exchange",), threads=1)


def _jax_exchange(jax_mesh, vals, dest, capacity, fill=-1):
    def shard_fn(v, d):
        recv, counts, overflow = jex.ragged_all_to_all(
            (v,), d, D, capacity, "x", (np.int32(fill),))
        return recv[0], counts, overflow.astype(jnp.int32)

    fn = jax.shard_map(shard_fn, mesh=jax_mesh, in_specs=(P("x"), P("x")),
                       out_specs=(P("x"), P("x"), P()))
    recv, counts, overflow = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(dest))
    return (np.asarray(recv).reshape(D, D, capacity),
            np.asarray(counts).reshape(D, D), bool(overflow))


def test_ragged_all_to_all_roundtrip(port, jax_mesh):
    vals, dest = R.inputs_roundtrip()
    jrecv, jcounts, jover = _jax_exchange(jax_mesh, vals, dest, R.N_PER)
    assert not jover
    for dst in range(D):
        got, counts, over = port[dst]["roundtrip"]
        assert not over
        np.testing.assert_array_equal(counts, jcounts[dst])
        want = np.concatenate([jrecv[dst, s, :jcounts[dst, s]]
                               for s in range(D)])
        np.testing.assert_array_equal(got, want)


def test_ragged_all_to_all_overflow_detected(port, jax_mesh):
    """Every row to rank 0 with capacity 1: both flag the overflow on every
    rank; the port's exchange still delivers every row, in source order."""
    vals, dest = R.inputs_roundtrip()
    _, _, jover = _jax_exchange(jax_mesh, vals, np.zeros_like(dest), 1, 0)
    assert jover
    assert all(p["overflow"][2] for p in port)
    np.testing.assert_array_equal(port[0]["overflow"][0], vals)
    assert all(p["overflow"][0].size == 0 for p in port[1:])
    assert not any(p["no_overflow"] for p in port)


def test_packed_all_to_all_multibucket_slices(port, jax_mesh):
    G, cap = 2, R.N_PER
    vals, dest, sub = R.inputs_multibucket(G)

    def shard_fn(v, d, s):
        parted, cnts, starts = jpart.stable_partition(s * D + d, (v,), D * G)
        outs = []
        for g in range(G):
            recv, rcounts, _ = jex.packed_all_to_all(
                parted, cnts[g * D:(g + 1) * D], starts[g * D:(g + 1) * D],
                D, cap, "x", (np.int32(-1),))
            outs += [recv[0], rcounts]
        return tuple(outs)

    fn = jax.shard_map(shard_fn, mesh=jax_mesh,
                       in_specs=(P("x"), P("x"), P("x")),
                       out_specs=tuple([P("x")] * (2 * G)))
    outs = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(dest),
                       jnp.asarray(sub))
    for g in range(G):
        jrecv = np.asarray(outs[2 * g]).reshape(D, D, cap)
        jcounts = np.asarray(outs[2 * g + 1]).reshape(D, D)
        for dst in range(D):
            got, counts = port[dst]["multibucket"][g]
            np.testing.assert_array_equal(counts, jcounts[dst])
            np.testing.assert_array_equal(got, np.concatenate(
                [jrecv[dst, s, :jcounts[dst, s]] for s in range(D)]))


def test_ragged_all_to_all_drop_mask_every_width(port, jax_mesh):
    """int16, u32, f32, u64 and f64 columns with a drop mask: the rows
    kept arrive bit for bit as the JAX exchange delivers them."""
    cols, dest, drop = R.inputs_mixed_dtypes()
    n_per = dest.size // D

    def shard_fn(d, m, *cs):
        recv, counts, _ = jex.ragged_all_to_all(
            cs, d, D, n_per, "x", tuple(np.zeros((), c.dtype) for c in cs),
            drop_mask=m)
        return tuple(recv) + (counts,)

    fn = jax.shard_map(shard_fn, mesh=jax_mesh,
                       in_specs=(P("x"),) * (2 + len(cols)),
                       out_specs=(P("x"),) * (1 + len(cols)))
    outs = jax.jit(fn)(jnp.asarray(dest), jnp.asarray(drop),
                       *map(jnp.asarray, cols))
    jcounts = np.asarray(outs[-1]).reshape(D, D)
    # the planes ride the block at their own width (int16, u32 and f32 as
    # one word a row, u64 and f64 two): some source's u64 plane starts at
    # an odd word offset of what its destination receives
    words = [1 if c.itemsize <= 4 else 2 for c in cols]
    assert any((sum(words) * int(jcounts[dst, :s].sum())
                + sum(words[:3]) * int(jcounts[dst, s])) % 2
               for dst in range(D) for s in range(D))
    for dst in range(D):
        got, counts = port[dst]["mixed_drop"]
        np.testing.assert_array_equal(counts, jcounts[dst])
        for i, c in enumerate(cols):
            jrecv = np.asarray(outs[i]).reshape(D, D, n_per)
            want = np.concatenate([jrecv[dst, s, :jcounts[dst, s]]
                                   for s in range(D)])
            assert got[i].dtype == want.dtype == c.dtype
            np.testing.assert_array_equal(got[i].view(np.uint8),
                                          want.view(np.uint8))


def test_exchange_and_dist_ops_partition_with_the_stream_pass(port):
    """The exchange, dist_sort_kv and the hash operators partition with
    stream.partition_planes (the radix kernels' pass), never the torch.sort
    engine."""
    for p in port:
        after_exchange, calls = p["spy"]
        assert after_exchange["partition_planes"] == 1
        # the sort's tie groups, its exchange, and one a hash shuffle
        assert calls["partition_planes"] >= 6
        assert calls["torch_sort_engine"] == 0


def test_slot_valid_mask_matches_jax():
    counts = np.array([3, 0, 5, 1], np.int32)
    want = np.asarray(jex.slot_valid_mask(4, 6, jnp.asarray(counts)))
    got = exchange.slot_valid_mask(4, 6, torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, want)


def test_shard_1d_matches_jax_sharding(port, jax_mesh):
    """Rank r's shard_1d slice is shard r of NamedSharding(mesh, P(x)) (on
    a divisible length), and the ceil split on 1001 rows."""
    x = np.arange(1000, dtype=np.int64)
    placed = jax.device_put(jnp.asarray(x), NamedSharding(jax_mesh, P("x")))
    shards = sorted(placed.addressable_shards, key=lambda s: s.index[0].start)
    cpu = mesh_lib.Mesh(0, D, torch.device("cpu"), "gloo")
    for r, sh in enumerate(shards):
        cpu.rank = r
        np.testing.assert_array_equal(
            mesh_lib.shard_1d(torch.from_numpy(x), cpu).numpy(),
            np.asarray(sh.data))
    per = -(-1001 // D)
    for r in range(D):
        np.testing.assert_array_equal(port[r]["shard"],
                                      np.arange(r * per, min(1001,
                                                             (r + 1) * per)))


def test_replicate_broadcasts_rank_zero(port):
    for p in port:
        np.testing.assert_array_equal(p["replicate"], [10, 10, 10])


def test_runtime_single_host_initialize():
    info = runtime.initialize()
    jinfo = jruntime.initialize()
    assert info.num_processes == jinfo.num_processes == 1
    assert info.process_id == 0
    assert info.global_devices >= 1


def test_runtime_health_check(port):
    for p in port:
        status = p["health"]
        assert status["ok"]
        assert status["devices"] == D
        # a real collective: every rank's token summed over the mesh
        assert status["heartbeat_total"] == D


def test_runtime_initialize_and_make_mesh_inside_a_group(port):
    """On a running group, initialize() describes it and make_mesh() is
    its mesh; another size or backend than the group's raises."""
    for r, p in enumerate(port):
        info, mesh, errors = p["running_group"]
        assert info == (r, D)
        assert mesh == (r, D, "gloo")
        assert errors == [["num_devices"], ["backend"]]


def test_runtime_health_check_timeout_path(monkeypatch):
    """A heartbeat that never completes surfaces as ok=False within
    timeout_s instead of hanging the caller."""
    def hanging(_mesh):
        def hang(_token):
            import time as _t
            _t.sleep(30.0)
        return hang

    monkeypatch.setattr(runtime, "_heartbeat_fn", hanging)
    mesh = mesh_lib.Mesh(0, 1, torch.device("cpu"), "gloo")
    status = runtime.health_check(mesh, timeout_s=1.0)
    assert not status["ok"]
    assert "timed out" in status["error"]


def test_runtime_health_check_setup_failure_path(monkeypatch):
    """A failed setup comes back as a status dict, never a raise."""
    def broken(_mesh):
        raise RuntimeError("backend wedged")

    monkeypatch.setattr(runtime, "_heartbeat_fn", broken)
    mesh = mesh_lib.Mesh(0, 1, torch.device("cpu"), "gloo")
    status = runtime.health_check(mesh, timeout_s=1.0)
    assert not status["ok"]
    assert "backend wedged" in status["error"]


def test_make_mesh_without_a_group_is_one_rank():
    """No group running: a world of one rank (gloo on the CPU) that runs
    the heartbeat; a mesh of more ranks needs a group and raises."""
    import torch.distributed as dist

    with pytest.raises(ValueError):
        mesh_lib.make_mesh(2, device="cpu")
    assert not dist.is_initialized()
    try:
        mesh = mesh_lib.make_mesh(device="cpu")
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        assert runtime.health_check(mesh)["heartbeat_total"] == 1
        assert "ranks=1" in mesh_lib.device_banner(mesh)
        with pytest.raises(ValueError):
            mesh_lib.make_mesh(backend="nccl")
    finally:
        dist.destroy_process_group()


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        mesh_lib.run_ranks(R.fail_on_rank_one, 2, backend="gloo",
                           device="cpu", threads=1, timeout_s=120)


def test_run_ranks_and_make_mesh_refuse_nccl_on_the_cpu():
    """NCCL moves CUDA tensors only: asking for it on the CPU raises before
    any rank starts or any group is made."""
    import torch.distributed as dist

    with pytest.raises(TypeError):  # backend and device are required
        mesh_lib.run_ranks(R.fail_on_rank_one, 1)
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.run_ranks(R.fail_on_rank_one, 1, backend="nccl",
                           device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.make_mesh(backend="nccl", device="cpu")
    assert not dist.is_initialized()


def test_cpu_call_after_a_nccl_default_group_raises(monkeypatch):
    """A call with mesh=None on CUDA tensors leaves a NCCL default group
    (make_mesh starts one); a later call on CPU tensors raises ValueError
    before any collective runs, instead of failing inside one."""
    import torch.distributed as dist

    from radix_sort_tpu_torch import Table
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort

    def no_collective(*_a, **_kw):
        raise AssertionError("a collective ran")

    for name, fn in (("is_initialized", lambda: True),
                     ("get_backend", lambda *_a: "nccl"),
                     ("get_world_size", lambda *_a: 1),
                     ("get_rank", lambda *_a: 0),
                     ("all_gather", no_collective),
                     ("all_reduce", no_collective),
                     ("all_to_all_single", no_collective)):
        monkeypatch.setattr(dist, name, fn)
    assert mesh_lib.make_mesh(device="cuda:0").device.type == "cuda"
    with pytest.raises(ValueError, match="NCCL"):
        mesh_lib.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        dist_sort.dist_sort_kv(torch.arange(8, dtype=torch.int32))
    t = Table.from_numpy({"k": np.arange(8, dtype=np.int32)}, device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        dist_ops.dist_hash_aggregate(t, "k", {"n": ("count", None)})
    with pytest.raises(ValueError, match="NCCL"):
        dist_ops.dist_top_k(t, "k", 2)
    with pytest.raises(ValueError, match="NCCL"):
        dist_ops.dist_hash_join(t, t, "k")


@pytest.mark.cuda
def test_cuda_one_nccl_rank_sort_and_ops():
    """One NCCL rank on the card: dist_sort_kv and config 5's operators
    launch the radix kernels and match numpy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = mesh_lib.run_ranks(R.nccl_case, 1, backend="nccl", device="cuda",
                             timeout_s=600)[0]
    assert res["launches"]["pass_histograms"] > 0
    assert res["launches"]["onesweep_pass"] > 0
    keys, vals = R.SORT_INPUTS["u32_full_kv"]()
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(res["sort"][0], keys[perm])
    np.testing.assert_array_equal(res["sort"][1], perm)
    probe, _ = R.config5_inputs()
    uk, cnt = np.unique(probe["k"], return_counts=True)
    order = np.argsort(res["agg"]["k"], kind="stable")
    np.testing.assert_array_equal(res["agg"]["k"][order], uk)
    np.testing.assert_array_equal(res["agg"]["n"][order], cnt)
    assert res["matches"] == probe["k"].size


def test_make_mesh_in_a_gloo_group_without_a_card_raises(monkeypatch):
    """Inside a running gloo group with no device named, the mesh goes on
    the card; where no card is visible it raises instead of settling on
    the CPU, and device="cpu" asks for the CPU."""
    import torch.distributed as dist

    for name, fn in (("is_initialized", lambda: True),
                     ("get_backend", lambda *_a: "gloo"),
                     ("get_world_size", lambda *_a: 2),
                     ("get_rank", lambda *_a: 1)):
        monkeypatch.setattr(dist, name, fn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="no CUDA card"):
        mesh_lib.make_mesh()
    mesh = mesh_lib.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type) == (1, 2, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert mesh_lib.make_mesh().device == torch.device("cuda", 0)


def test_initialize_under_torchrun_without_a_card_raises(monkeypatch):
    """A torchrun-style launch joins over NCCL unless the caller passes
    backend="gloo"; with no card visible, NCCL raises before the group is
    joined instead of settling on gloo."""
    import torch.distributed as dist

    joined = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "get_rank", lambda *_a: 0)
    monkeypatch.setattr(
        dist, "init_process_group",
        lambda backend, init_method=None, **kw: joined.append(
            (backend, init_method)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda *_a: None)
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"),
                       ("WORLD_SIZE", "2"), ("RANK", "0")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="backend='gloo'"):
        runtime.initialize()
    assert joined == []
    runtime.initialize(backend="gloo")
    assert joined == [("gloo", "env://")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    runtime.initialize()
    assert joined[-1] == ("nccl", "env://")
