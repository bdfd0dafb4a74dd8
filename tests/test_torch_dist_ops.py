"""The port's distributed operators (radix_sort_tpu_torch.parallel.dist_ops)
against the JAX package's on 4 ranks, at overlap_chunks G = 1 and G = 2.

The port's side runs once for the whole module on 4 gloo ranks
(``torch_dist_ranks.run_cases``): each rank holds its ``shard_table``
rows, and ``ShardedTable.to_numpy`` gathers the result in rank order.  The
JAX side runs the same numpy tables on a mesh of 4 of the 8 CPU devices.
The hash, the sub-chunk order and the stitch are the JAX package's, so
``to_numpy`` columns and ``match_count`` are compared bit for bit, row for
row, and against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from radix_sort_tpu.parallel import dist_ops as jops, dist_sort as jds
from radix_sort_tpu.parallel import mesh as jmesh
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import dtypes as tdt
from radix_sort_tpu_torch.parallel import dist_ops, mesh as mesh_lib

D = R.D


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(D)


@pytest.fixture(scope="module")
def port():
    return mesh_lib.run_ranks(R.run_cases, D, backend="gloo", device="cpu",
                              args=("ops",), threads=1)


def _jtable(cols, num_rows=None):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()},
                  num_rows=num_rows)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _same_on_every_rank(port, key):
    for p in port[1:]:
        _same(p[key][0], port[0][key][0])


@pytest.mark.parametrize("G", [1, 2])
def test_dist_hash_aggregate(port, jax_mesh, G):
    keys, vals = R.agg_inputs("aggregate")
    jres, jover = jops.dist_hash_aggregate(
        _jtable({"g": keys, "x": vals}), "g",
        {"n": ("count", None), "s": ("sum", "x")}, mesh=jax_mesh,
        overlap_chunks=G)
    assert not bool(jover)
    got, over = port[0][("aggregate", G)]
    assert not over
    _same(got, jres.to_numpy())
    _same_on_every_rank(port, ("aggregate", G))
    uk = np.unique(keys)
    order = np.argsort(got["g"], kind="stable")
    np.testing.assert_array_equal(got["g"][order], uk)
    np.testing.assert_array_equal(got["n"][order],
                                  [(keys == k).sum() for k in uk])
    np.testing.assert_array_equal(got["s"][order],
                                  [vals[keys == k].sum() for k in uk])


@pytest.mark.parametrize("G", [1, 2])
def test_dist_hash_aggregate_skew_escalation(port, jax_mesh, G):
    """Fewer distinct keys than ranks: the JAX shuffle escalates its
    capacity to finish; the exact exchange has nothing to escalate."""
    keys, vals = R.agg_inputs("aggregate_skew")
    jres, jover = jops.dist_hash_aggregate(
        _jtable({"g": keys, "x": vals}), "g",
        {"n": ("count", None), "s": ("sum", "x")}, mesh=jax_mesh,
        overlap_chunks=G)
    assert not bool(jover)
    got, over = port[0][("aggregate_skew", G)]
    assert not over
    _same(got, jres.to_numpy())
    uk, inv = np.unique(keys, return_inverse=True)
    order = np.argsort(got["g"], kind="stable")
    np.testing.assert_array_equal(got["g"][order], uk)
    np.testing.assert_array_equal(got["n"][order], np.bincount(inv))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("name", ["aggregate_u8", "aggregate_f16"])
def test_dist_hash_aggregate_narrow_keys(port, jax_mesh, name, G):
    """1-byte and half-precision group keys (for float16 NaN payloads,
    +-0.0, +-inf and subnormals, each bit pattern a group of its own),
    widened before the hash as the JAX package widens them: the groups
    equal the JAX function's bit for bit, and the numpy oracle's."""
    keys, vals = R.agg_inputs(name)
    jres, jover = jops.dist_hash_aggregate(
        _jtable({"g": keys, "x": vals}), "g",
        {"n": ("count", None), "s": ("sum", "x")}, mesh=jax_mesh,
        overlap_chunks=G)
    assert not bool(jover)
    got, over = port[0][(name, G)]
    assert not over
    want = jres.to_numpy()
    _same(got, want)
    np.testing.assert_array_equal(got["g"].view(np.uint8),
                                  want["g"].view(np.uint8))
    _same_on_every_rank(port, (name, G))
    u = f"u{keys.dtype.itemsize}"
    ub, inv = np.unique(keys.view(u), return_inverse=True)
    order = np.argsort(got["g"].view(u), kind="stable")
    np.testing.assert_array_equal(got["g"].view(u)[order], ub)
    np.testing.assert_array_equal(got["n"][order], np.bincount(inv))
    np.testing.assert_array_equal(got["s"][order],
                                  np.bincount(inv, weights=vals))


def _check_join(port, jax_mesh, name, G, mult):
    probe, build, brows = R.join_inputs(name)
    jres, jstats = jops.dist_hash_join(
        _jtable(probe), _jtable(build, brows), "k", mesh=jax_mesh,
        overlap_chunks=G)
    assert not bool(jstats["overflow"])
    got, matches, over = port[0][(name, G)]
    assert not over
    assert matches == int(jstats["match_count"])
    _same(got, jres.to_numpy())
    _same_on_every_rank(port, (name, G))
    bk = build["k"][:brows]
    assert matches == got["k"].size == int(np.isin(probe["k"], bk).sum())
    np.testing.assert_array_equal(got["bv"], got["k"].astype(np.int32) * mult)
    return probe, bk, got


@pytest.mark.parametrize("G", [1, 2])
def test_dist_hash_join(port, jax_mesh, G):
    probe, bk, got = _check_join(port, jax_mesh, "join", G, 10)
    keep = set(bk.tolist())
    exp = sorted((int(k), i) for i, k in enumerate(probe["k"]) if k in keep)
    assert sorted(zip(got["k"].tolist(), got["pv"].tolist())) == exp


@pytest.mark.parametrize("G", [1, 2])
def test_dist_hash_join_skew_escalation(port, jax_mesh, G):
    """Probe keys on 4 distinct values: every match present exactly
    once, in the JAX order."""
    _check_join(port, jax_mesh, "join_skew", G, 3)


@pytest.mark.parametrize("G", [1, 2])
def test_config5_join_aggregate_sort(port, jax_mesh, G):
    """BASELINE config 5 at 4 x 2^10 probe rows: the join, the count
    aggregate and the KV sort of the skewed keys, as
    scripts/baseline_configs.py checks them, and equal to the JAX ones."""
    probe, build = R.config5_inputs()
    pt, bt = _jtable(probe), _jtable(build)
    jj, jst = jops.dist_hash_join(pt, bt, "k", mesh=jax_mesh,
                                  overlap_chunks=G)
    ja, _ = jops.dist_hash_aggregate(pt, "k", {"n": ("count", None)},
                                     mesh=jax_mesh, overlap_chunks=G)
    jk, jv, _ = jds.dist_sort_kv(jnp.asarray(probe["k"]),
                                 jnp.asarray(probe["pv"]), mesh=jax_mesh,
                                 overlap_chunks=G)
    joined, matches, agg, ks, vs = port[0][("config5", G)]
    _same(joined, jj.to_numpy())
    assert matches == int(jst["match_count"]) == probe["k"].size
    np.testing.assert_array_equal(joined["bv"],
                                  (joined["k"] * 7).astype(np.int32))
    _same(agg, ja.to_numpy())
    uk, cnt = np.unique(probe["k"], return_counts=True)
    order = np.argsort(agg["k"], kind="stable")
    np.testing.assert_array_equal(agg["k"][order], uk)
    np.testing.assert_array_equal(agg["n"][order], cnt)
    ks = np.concatenate([p[("config5", G)][3] for p in port])
    vs = np.concatenate([p[("config5", G)][4] for p in port])
    perm = np.argsort(probe["k"], kind="stable")
    np.testing.assert_array_equal(ks, np.asarray(jk))
    np.testing.assert_array_equal(vs, np.asarray(jv))
    np.testing.assert_array_equal(vs, perm)


def _check_topk(port, jax_mesh, name):
    cols, rows, k, largest = R.topk_inputs(name)
    want = jops.dist_top_k(_jtable(cols, rows), "k", k, largest=largest,
                           mesh=jax_mesh)
    for p in port:  # replicated: the same table on every rank
        got, n = p[("topk", name)]
        assert n == int(want.num_rows)
        _same(got, want.to_numpy())
    return port[0][("topk", name)][0], cols


def test_dist_top_k_unique_keys_with_payload(port, jax_mesh):
    got, cols = _check_topk(port, jax_mesh, "unique")
    exp = np.sort(cols["k"])[::-1][:10]
    np.testing.assert_array_equal(got["k"], exp)
    np.testing.assert_array_equal(got["v"], exp * 3 + 1)
    small, _ = _check_topk(port, jax_mesh, "unique_smallest")
    np.testing.assert_array_equal(small["k"], np.sort(cols["k"])[:7])


def test_dist_top_k_padding_rows_lose(port, jax_mesh):
    got, _ = _check_topk(port, jax_mesh, "padding")
    np.testing.assert_array_equal(got["k"], np.arange(300)[::-1][:5])


def test_dist_top_k_k_exceeds_per_device(port, jax_mesh):
    got, cols = _check_topk(port, jax_mesh, "k_exceeds_per_device")
    np.testing.assert_array_equal(got["k"], np.sort(cols["k"])[::-1][:100])


def test_dist_top_k_fewer_valid_rows_than_k(port, jax_mesh):
    got, _ = _check_topk(port, jax_mesh, "fewer_rows_than_k")
    np.testing.assert_array_equal(got["k"], [2, 1, 0])


def test_dist_top_k_ties_return_correct_multiset(port, jax_mesh):
    """Heavy ties: the same rows as the JAX selection, ties in (rank,
    local row) order."""
    got, cols = _check_topk(port, jax_mesh, "ties")
    np.testing.assert_array_equal(got["k"], np.sort(cols["k"])[::-1][:50])


KEY_DTYPES = [np.uint16, np.int16, np.uint32, np.int32, np.float32,
              np.uint64, np.int64]


@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("dtype", KEY_DTYPES,
                         ids=[np.dtype(d).name for d in KEY_DTYPES])
def test_hash_dest_sub_matches_jax(dtype, G):
    """The Fibonacci hash on keys with the top bits set, every width: the
    same (rank, sub-chunk) for every key."""
    d = np.dtype(dtype)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2**64, 4096, dtype=np.uint64)
    if d.itemsize < 8:
        bits = bits & np.uint64((1 << (8 * d.itemsize)) - 1)
    keys = bits.astype(f"u{d.itemsize}").view(d)
    keys[:4] = np.array([0, 1, 2**(8 * d.itemsize) - 1,
                         2**(8 * d.itemsize - 1)],
                        dtype=np.uint64).astype(f"u{d.itemsize}").view(d)
    if d.kind == "f":
        keys = keys[np.isfinite(keys)]
    jd, js = jops._hash_dest_sub(jnp.asarray(keys), 5, G)
    td, ts = dist_ops._hash_dest_sub(tdt.tensor_from_numpy(keys, "cpu"), 5,
                                     G)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert len(np.unique(td.numpy())) == 5


def test_shard_table_slices_rows_and_valid_counts():
    t = dist_ops.Table.from_numpy({"a": np.arange(10, dtype=np.int32)},
                                  num_rows=7, device="cpu")
    mesh = mesh_lib.Mesh(0, 4, torch.device("cpu"), "gloo")
    got = []
    for r in range(4):
        mesh.rank = r
        s = dist_ops.shard_table(t, mesh)
        got.append((s["a"].tolist(), int(s.num_rows)))
    assert got == [([0, 1, 2], 3), ([3, 4, 5], 3), ([6, 7, 8], 1),
                   ([9], 0)]
