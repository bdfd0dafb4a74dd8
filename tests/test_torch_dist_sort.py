"""The port's dist_sort (radix_sort_tpu_torch.parallel.dist_sort) against
the JAX package's on 4 ranks, at overlap_chunks G = 1 and G = 2.

The port's side runs once for the whole module on 4 gloo ranks
(``torch_dist_ranks.run_cases``); each rank sorts its ``shard_1d`` shard
and returns its shard of the result, and the shards concatenate into the
global result.  The JAX side sorts the same numpy keys on a mesh of 4 of
the 8 CPU devices.  Keys and payloads are compared bit for bit, and
against the stable numpy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_ranks as R
from radix_sort_tpu import dtypes as jdt, golden
from radix_sort_tpu.parallel import dist_sort as jds, mesh as jmesh
from radix_sort_tpu_torch import dtypes as tdt
from radix_sort_tpu_torch.parallel import dist_sort, mesh as mesh_lib

D = R.D


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh(D)


@pytest.fixture(scope="module")
def port():
    return mesh_lib.run_ranks(R.run_cases, D, backend="gloo", device="cpu",
                              args=("sort",), threads=1)


def _port_sorted(port, case, G):
    parts = [p[(case, G)] for p in port]
    assert not any(ovf for _, _, ovf in parts)
    ks = np.concatenate([k for k, _, _ in parts])
    vs = (None if parts[0][1] is None
          else np.concatenate([v for _, v, _ in parts]))
    return ks, vs


def _check(port, jax_mesh, case, G, total_order=False):
    """``total_order``: hold the keys to the stable argsort of their
    sortable images (NaNs by sign, -0.0 below +0.0), not np.sort's order,
    which puts every NaN last."""
    keys, vals = R.SORT_INPUTS[case]()
    jk, jv, jover = jds.dist_sort_kv(
        jnp.asarray(keys), None if vals is None else jnp.asarray(vals),
        mesh=jax_mesh, overlap_chunks=G)
    assert not bool(jover)
    ks, vs = _port_sorted(port, case, G)
    assert ks.dtype == keys.dtype
    np.testing.assert_array_equal(ks.view(np.uint8),
                                  np.asarray(jk).view(np.uint8))
    if total_order:
        perm = np.argsort(jdt.np_to_sortable_unsigned(keys), kind="stable")
        np.testing.assert_array_equal(ks.view(np.uint8),
                                      keys[perm].view(np.uint8))
    else:
        # by value: numpy's order puts +0.0 and -0.0 as they came
        np.testing.assert_array_equal(ks, golden.oracle_sort(keys))
        perm = golden.oracle_argsort(keys)
    if vals is not None:
        np.testing.assert_array_equal(vs, np.asarray(jv))
        np.testing.assert_array_equal(vs, perm)
    # the JAX output layout: rank r holds sorted rows [r*per, (r+1)*per)
    per = -(-keys.size // D)
    assert [p[(case, G)][0].size for p in port] == [
        min(per, max(0, keys.size - r * per)) for r in range(D)]


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("ds_name", ["Zeros", "RandomDistributed", "Random",
                                     "Range", "InvertedRange"])
def test_dist_sort_distributions(port, jax_mesh, ds_name, G):
    """All five reference distributions, Zeros (the maximal skew) too."""
    _check(port, jax_mesh, f"dist_{ds_name}", G)


@pytest.mark.parametrize("G", [1, 2])
def test_dist_sort_kv_stable(port, jax_mesh, G):
    _check(port, jax_mesh, "kv_stable", G)


@pytest.mark.parametrize("G", [1, 2])
def test_dist_sort_non_divisible_n(port, jax_mesh, G):
    _check(port, jax_mesh, "non_divisible", G)


def test_dist_sort_i64(port, jax_mesh):
    _check(port, jax_mesh, "i64", 2)


def test_dist_sort_f32(port, jax_mesh):
    """Float keys, the ±inf and ±0 edges included, bit for bit."""
    _check(port, jax_mesh, "f32", 2)


def test_dist_sort_skewed_zipf(port, jax_mesh):
    _check(port, jax_mesh, "zipf", 2)


@pytest.mark.parametrize("ds_name", ["Zeros", "RandomDistributed"])
def test_dist_sort_overlapped_chunks(port, jax_mesh, ds_name):
    """overlap_chunks=4: D*G = 16 intervals, four exchanges in flight."""
    _check(port, jax_mesh, f"overlap_{ds_name}", 4)


def test_dist_sort_overlapped_kv_stable(port, jax_mesh):
    _check(port, jax_mesh, "overlap_kv", 2)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("case", ["u32_full_kv", "u64_full_kv",
                                  "u64_full_kv_i64"])
def test_dist_sort_full_range_unsigned_kv(port, jax_mesh, case, G):
    """Keys at and above 2^31 (2^63), ties included: the splitter searches
    run in unsigned order on the signed containers.  An int64 payload rides
    the exchange and the rebalance as one 8-byte plane."""
    _check(port, jax_mesh, case, G)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("case", ["u8_kv", "f16_kv"])
def test_dist_sort_narrow_keys_kv(port, jax_mesh, case, G):
    """1-byte and half-precision keys (NaN payloads, +-0.0, +-inf and
    subnormals for float16), ties included, sorted at their own width on
    every rank, bit for bit."""
    _check(port, jax_mesh, case, G, total_order=True)


@pytest.mark.parametrize("G", [1, 2])
def test_dist_sort_fewer_keys_than_ranks(port, jax_mesh, G):
    _check(port, jax_mesh, "tiny", G)


def test_dist_sort_key_only(port):
    keys, _ = R.SORT_INPUTS["dist_Range"]()
    got = np.concatenate([p["dist_sort"] for p in port])
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_assign_destinations_matches_jax(port, jax_mesh, dtype, G):
    """_assign_destinations on full-range keys with ties on a duplicated
    splitter and on one above 2^31 (2^63), against the JAX function under
    shard_map: the same interval for every key on every rank."""
    keys, spl = R.inputs_assign(dtype, G)
    ju, jspl = jdt.to_sortable_unsigned(jnp.asarray(keys)), jnp.asarray(spl)

    def shard_fn(chunk):
        return jds._assign_destinations(chunk, jspl, D * G, "x")

    fn = jax.shard_map(shard_fn, mesh=jax_mesh, in_specs=P("x"),
                       out_specs=P("x"))
    want = np.asarray(jax.jit(fn)(ju))
    got = np.concatenate([p[("assign", np.dtype(dtype).name, G)]
                          for p in port])
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == D * G  # the ties spread over every interval


def test_choose_splitters_matches_jax():
    rng = np.random.default_rng(4)
    smp = rng.integers(0, 2**32, 256, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jds._choose_splitters(jnp.asarray(smp), 8))
    got = dist_sort._choose_splitters(
        tdt.to_sortable(tdt.tensor_from_numpy(smp, "cpu")), 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for count in (5, 300):
        x = torch.arange(17)
        np.testing.assert_array_equal(
            dist_sort._strided_samples(x, count).numpy(),
            np.asarray(jds._strided_samples(jnp.arange(17), count)))


def test_dist_sort_rejects_another_layout(port):
    assert all("layout of shard_1d" in p["bad_layout"] for p in port)
